"""Host ms a step the Trainer's loader spent blocked on a batch's decode
(data/loader.Loader's wait_ns over its waits, one a batch handed over),
over one more epoch of steps run by this reader after the traced
stretch, untraced, as the window runs them: an epoch's steps hold its
cold start (the decode pool starts anew each epoch) in the window's
proportion, and no set-up (whose first batch also waits for the
decoder's one-time start, ~1 s in a checkout's first run). Of
data_wait_ms.train's wait for the next batch, the decode's part; the
rest is the pinning and copy to the card. The steps are not compared
or counted by any other reader (this metric comes after theirs in
BENCHMARK.json's list)."""


def read(ctx):
    drv = ctx.driver
    trainer = getattr(drv, "trainer", None)
    loader = getattr(trainer, "train_loader", None)
    if loader is None or not hasattr(loader, "waits"):
        return None
    ns, waits = loader.wait_ns, loader.waits
    for _ in range(trainer.steps_per_epoch):
        drv.run_unit(ctx.units)
        ctx.units += 1
    waits = loader.waits - waits
    return (loader.wait_ns - ns) / 1e6 / waits if waits else None
