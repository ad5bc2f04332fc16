"""Graph loading: N-Triples parsing, vocab and labels, summaries, datasets."""
