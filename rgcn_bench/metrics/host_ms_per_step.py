"""The program's host ms an epoch (from the harness's ``on_epoch`` return
to its next call), over the window's epochs issued while the card was
still busy with the previous one (the queue ahead), outside the traced
stretch."""


def read(record):
    if not record.issue_ms:
        return None
    return sum(record.issue_ms) / len(record.issue_ms)
