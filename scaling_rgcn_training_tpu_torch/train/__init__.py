"""Training: losses, metrics, optimizer, transfer, trainer."""
