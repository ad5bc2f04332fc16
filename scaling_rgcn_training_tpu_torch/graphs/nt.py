"""N-Triples line parsing.

Reproduces the reference's idiosyncratic parse exactly (it is load-bearing for
vocab parity): each line is truncated by two characters (the trailing `` .``)
and split on the first two spaces, then lowercased
(reference: graphs/graph.py:32-34, graphs/graphProcessing.py:7-10).

Consequences preserved on purpose:
- literal objects keep their datatype suffix and any *extra* trailing
  whitespace that precedes the final `` .`` (the TEST fixture exercises this);
- blank lines produce ``''[:-2].split(...) == ['']`` and are skipped;
- everything is lowercased, so vocab is case-insensitive.

This is the pure-Python parser path of the JAX package's ``graphs/nt.py``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

RDF_TYPE = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"
# Predicates dropped from the relation vocabulary (reference: graphs/graph.py:41-44).
TYPE_PREDICATES = (RDF_TYPE, "<type>")
# Subjects under this namespace are excluded from class extraction
# (reference: graphs/graphProcessing.py:19,37).
SWRC_NAMESPACE = "http://swrc.ontoware.org/ontology"


def read_lines(path: str) -> List[str]:
    """Read a .nt file into raw lines (reference: graphs/graphProcessing.py:7-10)."""
    with open(path, "r") as fh:
        return fh.read().splitlines()


def split_triple(line: str) -> Optional[Tuple[str, str, str]]:
    """Split one raw .nt line into a lowercased (s, p, o) triple.

    Returns None for lines the reference skips (empty lines). Mirrors
    ``triple[:-2].split(" ", maxsplit=2)`` + lowercasing
    (reference: graphs/graph.py:32-34).
    """
    parts = line[:-2].split(" ", maxsplit=2)
    if parts == [""] or len(parts) < 3:
        return None
    return parts[0].lower(), parts[1].lower(), parts[2].lower()


def iter_triples(lines: List[str]) -> Iterator[Tuple[str, str, str]]:
    for line in lines:
        t = split_triple(line)
        if t is not None:
            yield t


def count_unique_lines(path: str) -> int:
    """Unique raw line count = the reference's ``num_edges`` (graph.py:29,39)."""
    with open(path, "r") as fh:
        return len(set(fh.read().splitlines()))


def read_triples(path: str) -> List[Tuple[str, str, str]]:
    """Parse a .nt file into lowercased (s, p, o) triples.

    Pure-Python path.
    """
    return list(iter_triples(read_lines(path)))
