"""Config checks (reference helpers/checks.py:6-31).

- sum/map file pairing assert;
- round ``emb`` to a multiple of the number of summary files (the attention
  head needs embed_dim divisible by num_heads == num summaries);
- set ``num_sums`` (1 when embedding transfer is off).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


def check_sum_map_files(sum_path: str, map_path: str) -> List[str]:
    sum_files = [f for f in os.listdir(sum_path)
                 if not f.startswith(".") and os.path.isfile(os.path.join(sum_path, f))]
    map_files = [f for f in os.listdir(map_path)
                 if not f.startswith(".") and os.path.isfile(os.path.join(map_path, f))]
    assert len(sum_files) == len(map_files), (
        f"summary/map files must pair up 1:1, but {sum_path} has "
        f"{len(sum_files)} summaries while {map_path} has {len(map_files)} maps")
    return sum_files


def check_emb_dim(configs: Dict, num_sum_files: int) -> Dict:
    emb_dim = configs["emb"]
    new_emb = round(emb_dim / num_sum_files) * num_sum_files
    configs["emb"] = new_emb
    if new_emb != emb_dim:
        print(f"emb_dim {emb_dim} -> {new_emb}: rounded to a multiple of the "
              f"{num_sum_files} summaries so attention heads divide evenly")
    return configs


def check_e_trans(configs: Dict, num_sum_files: int) -> Dict:
    configs["num_sums"] = num_sum_files if configs.get("e_trans", True) else 1
    return configs


def do_checks(configs: Dict, sum_path: str, map_path: str) -> Tuple[Dict, List[str]]:
    sum_files = check_sum_map_files(sum_path, map_path)
    configs = check_emb_dim(configs, len(sum_files))
    configs = check_e_trans(configs, len(sum_files))
    return configs, sum_files
