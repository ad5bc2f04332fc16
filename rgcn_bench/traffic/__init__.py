"""Traffic generators: a mix ``traffic/<name>.json`` names one of these
modules under ``generator`` and holds its parameters."""
