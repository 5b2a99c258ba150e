"""The conv epilogue's second-stage mode (csrc/conv_epilogue.cu, the
kernels named ``epilogue_merge``) against its roofline: the least time of
the second-stage epilogues the traced window ran (their bf16 values read
once and written once and their (b, s, t) read, at the HBM rate;
``counts_p6``), over those kernels' device time, in percent.  The
forwards are counted by the program's ``forward`` spans' ``merges``
(seven a P6 forward); None without them or without the kernel."""

from perfbench.harness import counts_p6, program_trace, readers

KERNELS = ("epilogue_merge",)


def read(ctx):
    if ctx.run.trace is None:
        return None
    got = program_trace.window_spans(ctx)
    if not got:
        return None
    merges = sum(s.counts.get("merges", 0) for s in got
                 if s.name == "forward")
    spent = sum(e - s for _, s, e in readers.window_events(
        ctx, "kernel", KERNELS)) / 1e9
    if not merges or not spent:
        return None
    cfg = ctx.cell.config
    forwards = merges / counts_p6.MERGE_SITES
    least = forwards * counts_p6.merge_least_s(
        ctx.run.calls[0]["images"], cfg["img_size"], cfg["num_classes"], tuple(cfg["csp_repeats"]))
    return 100.0 * least / spent
