"""Device ms a unit of the hybrid's stage 1 (the program's span
`hybrid.stage1`: B1 and its tail in fused_hybrid_model, the plain RRDB
through api.upscale), its kernels and copies by their launch
(program_spans.py's second profiled stretch). Bias: the stretch runs
under CUPTI, which slows the host, not the kernels."""

from portbench import program_spans


def read(ctx):
    st = program_spans.stretch(ctx)
    return st.device_ms("hybrid.stage1") if st else None
