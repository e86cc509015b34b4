"""Device ms an optimizer step under the program's span `train.optimizer`
(the logged global norm, the clip and AdamW over every leaf), its
kernels and copies by their launch (program_spans.py's second profiled
stretch). Bias: the stretch runs under CUPTI, which slows the host, not
the kernels."""

from portbench import program_spans


def read(ctx):
    st = program_spans.stretch(ctx)
    return st.device_ms("train.optimizer") if st else None
