"""Results accumulation / reporting (reference helpers/results.py:14-132).

Drop-in JSON schema compatibility:
- ``run_results_{exp}_{sum}_i={i}.json``: per experiment, per metric,
  ``[mean_series, mean-std, mean+std]`` rounded to 4 decimals;
- ``report_{exp}_{sum}_i={i}.json``: configs + per-metric
  ``{'epoch': argmax_index - 1, 'max': percent}`` + test mean±std;
- optional matplotlib curves with the frozen baseline band when a
  ``baselines/{ds}_baseline`` file is available (results.py:70-117).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np


class Results:
    def __init__(self) -> None:
        self.run_results: Dict[str, Dict[str, list]] = {}
        self.test_accs = defaultdict(list)
        self.test_f1_weighted = defaultdict(list)
        self.test_f1_macro = defaultdict(list)

    def add_key(self, key: str) -> None:
        if key not in self.run_results:
            self.run_results[key] = defaultdict(list)

    def update_run_results(self, new_results: Dict[str, list], exp: str) -> None:
        for key, value in new_results.items():
            self.run_results[exp][key].append(np.array(value))

    def add_test_results(self, exp: str, acc: float, f1_w: float, f1_m: float) -> None:
        self.test_accs[f"Test acc {exp}"].append(acc)
        self.test_f1_weighted[f"Test F1 weighted {exp}"].append(f1_w)
        self.test_f1_macro[f"Test F1 macro {exp}"].append(f1_m)

    # -- aggregation: mean +/- std band per metric across iterations --------
    # (output-schema parity with reference results.py:39-46: three rounded
    # series [mean, mean-std, mean+std])

    @staticmethod
    def _band(array_list: List[np.ndarray]) -> List[list]:
        arr = np.asarray(array_list, dtype=np.float64)
        mu, sd = arr.mean(axis=0), arr.std(axis=0)
        return [list(np.around(series, 4)) for series in (mu, mu - sd, mu + sd)]

    def make_av_run_results(self) -> None:
        self.run_results = {
            exp: {metric: self._band(runs) for metric, runs in value.items()}
            for exp, value in self.run_results.items()
        }

    # -- report: best-epoch + test mean/std, percent scale -------------------
    # (schema parity with reference results.py:48-68, including its
    # ``epoch - 1`` convention: the reference evaluates validation BEFORE
    # the epoch's update, so series index e reflects e prior updates)

    @staticmethod
    def _peak(series: list) -> Dict[str, Any]:
        best = int(np.argmax(series))
        return {"epoch": best - 1, "max": round(float(series[best]) * 100, 2)}

    @staticmethod
    def _pct_stats(values: List[float]) -> Dict[str, float]:
        pct = np.asarray(values, dtype=np.float64) * 100
        return {"mean": round(float(pct.mean()), 2),
                "std": round(float(pct.std()), 2)}

    def create_run_report(self, path: str, configs: Dict[str, Any]) -> None:
        report: Dict[str, Any] = defaultdict(dict)
        report.update(configs)
        for experiment, metric_results in self.run_results.items():
            for metric, results in metric_results.items():
                report[experiment][metric] = self._peak(results[0])
        for test_dict in (self.test_accs, self.test_f1_weighted,
                          self.test_f1_macro):
            report.update({exp: self._pct_stats(vals)
                           for exp, vals in test_dict.items()})
        with open(f'{path}/report_{configs["exp"]}_{configs["sum"]}_i={configs["i"]}.json',
                  "w") as fh:
            json.dump(report, fh, indent=4, default=str)

    def save_to_json(self, path: str, configs: Dict[str, Any]) -> None:
        with open(f'{path}/run_results_{configs["exp"]}_{configs["sum"]}_i={configs["i"]}.json',
                  "w") as fh:
            json.dump(self.run_results, fh, indent=4, default=str)

    # -- plots (results.py:70-117), optional -------------------------------

    def plot_results(self, path: str, configs: Dict[str, Any],
                     baselines_dir: str = "./baselines") -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return

        epochs = configs["epochs"]
        epoch_list = list(range(epochs))
        colors = {"attention": "#FF0000", "summation": "#069AF3", "mlp": "#15B01A",
                  "baseline": "#FAC205"}

        baseline_file = os.path.join(
            baselines_dir, f'{configs["dataset"]}_baseline', "run_results_baseline_i=5.json")
        b_results: Optional[dict] = None
        if os.path.exists(baseline_file):
            with open(baseline_file) as fh:
                b_results = json.load(fh).get("baseline")

        metrics = set()
        for exp in self.run_results:
            metrics.update(self.run_results[exp].keys())

        # reference parity (results.py:88-116): ONE PDF per (exp, metric),
        # named {ds}_{exp}_{metric}_{sum}_i={i}.pdf, each carrying that
        # experiment's curve over the baseline band, with the reference's
        # fixed ticks (x step 5; y [0, 1.1) step 0.1, expanded for >1
        # bands e.g. loss). Band source: the frozen baselines file when
        # present, else this run's own baseline series.
        for metric in sorted(metrics):
            band = None
            if b_results and metric in b_results:
                band = [b_results[metric][k][:epochs] for k in range(3)]
            elif metric in self.run_results.get("baseline", {}):
                band = self.run_results["baseline"][metric]
            for exp, series in self.run_results.items():
                if metric not in series:
                    continue
                plt.figure()
                if exp != "baseline":
                    y, y1, y2 = series[metric]
                    x = epoch_list[:len(y)]
                    c = colors.get(exp, "#888888")
                    plt.fill_between(x, y1[:len(x)], y2[:len(x)], color=c,
                                     alpha=0.2)
                    plt.plot(x, y[:len(x)], color=c, label=f"{exp} {metric}")
                ylim, step = 1.1, 0.1
                if band is not None:
                    yb = band[0]
                    xb = epoch_list[:len(yb)]
                    plt.fill_between(xb, band[1][:len(xb)], band[2][:len(xb)],
                                     color="#FAC205", alpha=0.45)
                    plt.plot(xb, yb, color="#FAC205",
                             label=f"baseline {metric}")
                    if max(band[2]) > 1:
                        ylim, step = round(max(band[2]) + 1.0), 0.5
                plt.title(f'{exp} {metric} on {configs["dataset"]} dataset '
                          f'during training epochs ({configs["sum"]})')
                plt.xlabel("Epochs")
                plt.ylabel(metric)
                plt.grid(color="b", linestyle="-", linewidth=0.1)
                plt.margins(x=0)
                plt.legend(loc="best")
                plt.xticks(np.arange(0, len(epoch_list), 5))
                plt.xlim(xmin=0)
                plt.yticks(np.arange(0, ylim, step))
                plt.ylim(ymin=0)
                plt.savefig(
                    f'{path}/{configs["dataset"]}_{exp}_{metric}_'
                    f'{configs["sum"]}_i={configs["i"]}.pdf',
                    format="pdf")
                plt.close()

    # -- driver (results.py:123-132) ---------------------------------------

    def process_results(self, configs: Dict[str, Any],
                        results_root: str = "./results",
                        baselines_dir: str = "./baselines",
                        plots: bool = True) -> str:
        str_date = datetime.now().strftime("%d%B%Y-%H%M")
        path = os.path.join(
            results_root,
            f'{configs["dataset"]}_{configs["exp"]}_{configs["sum"]}_i={configs["i"]}_{str_date}')
        os.makedirs(path, exist_ok=True)
        self.make_av_run_results()
        self.save_to_json(path, configs)
        self.create_run_report(path, configs)
        if plots:
            self.plot_results(path, configs, baselines_dir)
        return path
