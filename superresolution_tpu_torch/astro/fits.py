"""Minimal FITS image I/O (primary HDU only), per the FITS 4.0 standard.

Covers what the reference pipeline needs (reference:
scripts/Dataset_step1_datasetwcs.py, Dataset_step3/4): reading 2-D images
of BITPIX 8/16/32/-32/-64 with BSCALE/BZERO, reading/writing header cards
(for WCS), and writing float32 images.

The port's own copy of superresolution_tpu/astro/fits.py, line for line
(plain numpy on the host; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
_BITPIX_DTYPE = {
    8: np.dtype(">u1"), 16: np.dtype(">i2"), 32: np.dtype(">i4"),
    64: np.dtype(">i8"), -32: np.dtype(">f4"), -64: np.dtype(">f8"),
}


def _parse_card(card: str):
    key = card[:8].strip()
    if key in ("COMMENT", "HISTORY", "") or card[8:10] != "= ":
        return key, None
    body = card[10:]
    # strip inline comment (outside quoted strings)
    if body.lstrip().startswith("'"):
        s = body.lstrip()
        end = s.find("'", 1)
        while end != -1 and end + 1 < len(s) and s[end + 1] == "'":
            end = s.find("'", end + 2)
        val = s[1:end].replace("''", "'").rstrip()
        return key, val
    if "/" in body:
        body = body.split("/", 1)[0]
    v = body.strip()
    if v == "T":
        return key, True
    if v == "F":
        return key, False
    try:
        return key, int(v)
    except ValueError:
        pass
    try:
        return key, float(v)
    except ValueError:
        return key, v


def read_fits(path: str):
    """Returns (data: 2-D float64 array or None, header: dict)."""
    header: dict = {}
    with open(path, "rb") as f:
        # header blocks
        raw = b""
        while True:
            blk = f.read(BLOCK)
            if len(blk) < BLOCK:
                raise ValueError(f"truncated FITS header in {path}")
            raw += blk
            if b"END     " in blk or blk.rstrip().endswith(b"END"):
                text = raw.decode("ascii", errors="replace")
                cards = [text[i:i + 80] for i in range(0, len(text), 80)]
                done = False
                for c in cards:
                    # the END card is the bare keyword 'END' in the
                    # 8-char keyword field — a prefix match would stop
                    # at ENDTIME/ENDDATE and drop later WCS cards
                    if c[:8].strip() == "END":
                        done = True
                        break
                    k, v = _parse_card(c)
                    if k and v is not None:
                        header[k] = v
                if done:
                    break
        naxis = int(header.get("NAXIS", 0))
        if naxis == 0:
            return None, header
        shape = tuple(int(header[f"NAXIS{i}"])
                      for i in range(naxis, 0, -1))
        bitpix = int(header["BITPIX"])
        dt = _BITPIX_DTYPE[bitpix]
        count = int(np.prod(shape))
        buf = f.read(count * dt.itemsize)
        data = np.frombuffer(buf, dtype=dt, count=count).reshape(shape)
        data = data.astype(np.float64)
        bscale = float(header.get("BSCALE", 1.0))
        bzero = float(header.get("BZERO", 0.0))
        if bscale != 1.0 or bzero != 0.0:
            data = data * bscale + bzero
    if data.ndim > 2:  # take the first plane (reference uses 2-D frames)
        data = data.reshape(-1, *data.shape[-2:])[0]
    return data, header


def _format_card(key: str, value) -> str:
    if isinstance(value, bool):
        v = "T" if value else "F"
        card = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {value:>20.13E}"
    else:
        s = str(value).replace("'", "''")
        # a string value must keep its closing quote within the 80-col
        # card: truncate the value, never the quote
        s = s[:68]
        if s.count("'") % 2:  # don't cut an escaped '' in half
            s = s[:-1]
        card = f"{key:<8}= '{s:<8}'"
    return card.ljust(80)[:80]


def write_fits(path: str, data: np.ndarray, header: dict | None = None) -> None:
    """Write a 2-D float32 primary-HDU FITS image with `header` WCS cards."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError("write_fits supports 2-D images")
    cards = [
        _format_card("SIMPLE", True),
        _format_card("BITPIX", -32),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", data.shape[1]),
        _format_card("NAXIS2", data.shape[0]),
    ]
    reserved = {"SIMPLE", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "END",
                "BSCALE", "BZERO", "EXTEND"}
    for k, v in (header or {}).items():
        if k.upper() not in reserved:
            cards.append(_format_card(k.upper()[:8], v))
    cards.append("END".ljust(80))
    htext = "".join(cards)
    pad = (-len(htext)) % BLOCK
    htext += " " * pad
    body = data.astype(">f4").tobytes()
    bpad = (-len(body)) % BLOCK
    import os
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(htext.encode("ascii"))
        f.write(body)
        f.write(b"\x00" * bpad)
