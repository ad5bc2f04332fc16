"""Host ms of a fit's start: the median, over the process's finished fits
after its first, of the program's spans ``fit.prepare`` + ``fit.warmup``
+ ``fit.capture`` + ``fit.readback`` + ``fit.close`` less the warm-up
epochs' own device time by their stamps (``utils/tracing.py``
``fit_start_ns``): what a fine-tune costs besides its epochs' work, the
card's wait for its queued replays (``fit.drain``) and the caller's
``on_epoch``."""

from rgcn_bench.program_trace import median_ms, recorder


def read(record):
    tracing = recorder()
    if tracing is None:
        return None
    starts = [tracing.fit_start_ns(f["fit"]) for f in tracing.fits()[1:]]
    return median_ms([s for s in starts if s is not None])
