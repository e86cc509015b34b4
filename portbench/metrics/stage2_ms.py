"""Device ms a unit of the hybrid's stage 2 (the program's span
`hybrid.stage2`: kernels 7-9 and their glue in fused_hybrid_model, the
plain HAT modules with kernel 10 through api.upscale), its kernels and
copies by their launch (program_spans.py's second profiled stretch).
Bias: the stretch runs under CUPTI, which slows the host, not the
kernels."""

from portbench import program_spans


def read(ctx):
    st = program_spans.stretch(ctx)
    return st.device_ms("hybrid.stage2") if st else None
