"""Kernels a unit launched under the program's span `hybrid.stage2`
(program_spans.py's second profiled stretch): the host's dispatch of
stage 2, a count."""

from portbench import program_spans


def read(ctx):
    st = program_spans.stretch(ctx)
    return st.launches("hybrid.stage2") if st else None
