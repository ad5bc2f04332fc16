"""Summary-graph construction (reference graphs/createAttributeSum.py)."""
