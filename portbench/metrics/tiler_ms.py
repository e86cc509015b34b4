"""Device ms a frame of the tiler's own work (the program's spans
`tiler.gather`, the edge indexing and stack of the tiles, and
`tiler.scatter`, the last chunk's padding and the placing of the output
tiles), the model's calls left out, by their launch (program_spans.py's
second profiled stretch). Bias: the input's copy to the card and the
trunk outputs' concatenation sit in the tiler's root, not here."""

from portbench import program_spans


def read(ctx):
    st = program_spans.stretch(ctx)
    if st is None:
        return None
    parts = [st.device_ms(n) for n in ("tiler.gather", "tiler.scatter")]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
