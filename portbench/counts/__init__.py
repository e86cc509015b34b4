"""Operation and byte counts of the port's kernels and models, from
shapes alone, and the card's peaks: the arithmetic of the roofline and
MFU metrics (frozen from PERF.md's kernel table and chip_smoke.py's
bound())."""
