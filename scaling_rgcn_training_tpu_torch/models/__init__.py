"""The embedding model of the summation and baseline experiments."""
