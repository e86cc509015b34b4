"""Device-idle ms a unit in gaps whose ending work was launched inside
the program's model call (the span `hybrid` for a patch, `train.step`
for an optimizer step), each counted from the span's opening on: the
card waiting for the host's dispatch of the model, not for the fetch
of a batch or the harness's loop (program_spans.py's second profiled
stretch). Bias: CUPTI costs the host some 10-15 us a launch, so a
traced stretch's gaps are longer than the untraced window's: compare
two versions within one check, not as absolute stalls."""

from portbench import program_spans


def read(ctx):
    st = program_spans.stretch(ctx)
    if st is None:
        return None
    return st.gap_ms("train.step" if ctx.driver.training else "hybrid")
