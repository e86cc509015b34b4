"""Device ms an optimizer step under the program's span `train.backward`
(torch.autograd.grad, with the kernels the autograd engine's thread
launches while the step waits in it; under accumulation every
micro-batch's), its kernels and copies by their launch (program_spans.py's
second profiled stretch). Bias: the stretch runs under CUPTI, which
slows the host, not the kernels."""

from portbench import program_spans


def read(ctx):
    st = program_spans.stretch(ctx)
    return st.device_ms("train.backward") if st else None
