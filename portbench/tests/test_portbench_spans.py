"""The span readers (metrics/stage1_ms.py and the others that read
program_spans.py) on synthetic traces: each reads what its docstring
says, a gap is labelled by the span its ending work was launched in,
the readers of a tree without the program's recorder read nothing, and
every other reader reads the same with the program's spans present as
without them."""

import json
from types import SimpleNamespace

import pytest

from portbench import common, program_spans, run
from portbench.tests.tiny import tiny_cell
from portbench.tracing import Trace
from superresolution_tpu_torch.utils.profiling import Span

NEW = {"loader_wait_ms.train", "stage1_ms.patch", "stage2_ms.patch",
       "stage2_launches.patch", "dispatch_gap_ms.patch", "stage1_ms.infer",
       "stage2_ms.infer", "tiler_ms.infer", "fwd_ms.train", "bwd_ms.train",
       "opt_ms.train", "dispatch_gap_ms.train"}


def spans(*rows):
    """profiling.Span records from (name, start us, end us, parent)."""
    out = []
    for name, s, e, parent in rows:
        root = out[parent].root if parent >= 0 else len(out)
        out.append(Span(name, int(s * 1000), int(e * 1000), parent, root))
    return out


def events(*work):
    """Chrome events of (cat, start us, dur us, launch us or None); each
    launch gets its own correlation id."""
    evs = []
    for i, (cat, ts, dur, launch) in enumerate(work):
        evs.append({"ph": "X", "cat": cat, "name": f"w{i}", "ts": ts,
                    "dur": dur, "args": {"correlation": i}})
        if launch is not None:
            call = "cudaMemcpyAsync" if cat == "gpu_memcpy" else \
                "cudaLaunchKernel"
            evs.append({"ph": "X", "cat": "cuda_runtime", "name": call,
                        "ts": launch, "dur": 1.0,
                        "args": {"correlation": i}})
    return evs


# one patch: stage 1 at 10-40 us, stage 2 at 50-90, the blurs in the root
PATCH_ROWS = (("hybrid", 0, 100, -1), ("hybrid.stage1", 10, 40, 0),
              ("hybrid.stage2", 50, 90, 0))
PATCH_SPANS = spans(*PATCH_ROWS)
PATCH_WORK = events(
    ("gpu_memcpy", 8, 2, 5),    # root; ends the gap 0-8
    ("kernel", 20, 10, 15),     # stage 1; ends the gap 10-20
    ("kernel", 30, 10, 25),     # stage 1
    ("kernel", 60, 5, 55),      # stage 2; ends the gap 40-60
    ("kernel", 65, 15, 58),     # stage 2
    ("kernel", 96, 2, 95),      # root; ends the gap 80-96
    ("kernel", 121, 4, 120))    # outside; ends the gap 98-121


def span_trace(sp, evs, units=2, end=130.0):
    return program_spans.from_events(evs, sp, 0.0, 0.0, end, units)


def ctx_with(st, training=False, **kw):
    return SimpleNamespace(program_spans=st, driver=SimpleNamespace(
        training=training), **kw)


def read(name, ctx):
    return common.load_module(common.reader_path(name)).read(ctx)


def test_the_patch_readers():
    ctx = ctx_with(span_trace(PATCH_SPANS, PATCH_WORK))
    # two units: every number halved
    assert read("stage1_ms.patch", ctx) == pytest.approx(0.020 / 2)
    assert read("stage2_ms.patch", ctx) == pytest.approx(0.020 / 2)
    assert read("stage2_launches.patch", ctx) == 1.0
    assert read("dispatch_gap_ms.patch", ctx) == pytest.approx(
        (8 + 10 + 20 + 16) / 1e3 / 2)
    assert read("stage1_ms.infer", ctx) == pytest.approx(0.010)
    assert ctx.program_spans.covered() == pytest.approx(42 / 46)


def test_the_tiler_reader_leaves_the_model_out():
    sp = spans(("tiler", 0, 100, -1), ("tiler.gather", 5, 20, 0),
               ("hybrid", 20, 60, 0), ("tiler.scatter", 60, 70, 0),
               ("tiler.scatter", 80, 90, 0))
    evs = events(("kernel", 10, 3, 6), ("kernel", 30, 20, 25),
                 ("gpu_memcpy", 62, 4, 61), ("kernel", 85, 5, 82),
                 ("kernel", 95, 1, 93))
    ctx = ctx_with(span_trace(sp, evs, units=1))
    assert read("tiler_ms.infer", ctx) == pytest.approx(0.012)
    assert read("stage1_ms.infer", ctx) is None  # no such span


def test_the_train_readers():
    sp = spans(("train.step", 0, 100, -1), ("train.forward", 10, 30, 0),
               ("train.backward", 30, 70, 0), ("train.optimizer", 75, 95, 0),
               ("train.step", 120, 200, -1))
    evs = events(
        ("kernel", 12, 8, 11),      # forward
        ("kernel", 40, 20, 35),     # backward (the engine's thread)
        ("kernel", 60, 6, 50),      # backward
        ("kernel", 80, 9, 78),      # optimizer; ends the gap 66-80
        ("kernel", 98, 1, 97),      # step's root; ends the gap 89-98
        ("gpu_memcpy", 110, 5, 105),  # the next batch's copy, outside
        ("kernel", 130, 2, 125))    # the next step's; ends the gap 115-130
    ctx = ctx_with(span_trace(sp, evs, units=1, end=210.0), training=True)
    assert read("fwd_ms.train", ctx) == pytest.approx(0.008)
    assert read("bwd_ms.train", ctx) == pytest.approx(0.026)
    assert read("opt_ms.train", ctx) == pytest.approx(0.009)
    # 0-12 (forward), 20-40 (backward), 66-80, 89-98; not 99-110 (ended
    # outside a step); of 115-130 the part after the step opened, 120-130
    assert read("dispatch_gap_ms.train", ctx) == pytest.approx(
        (12 + 20 + 14 + 9 + 10) / 1e3)


def fake_trainer(waits_ms):
    """A driver whose steps each wait on its loader for the next of
    waits_ms, the loader having waited 1 s already (set-up's)."""
    loader = SimpleNamespace(wait_ns=10**9, waits=5)
    it = iter(waits_ms)

    def run_unit(i):
        loader.wait_ns += int(next(it) * 1e6)
        loader.waits += 1

    return SimpleNamespace(training=True, run_unit=run_unit,
                           trainer=SimpleNamespace(
                               train_loader=loader,
                               steps_per_epoch=len(waits_ms)))


def test_the_loader_reader_reads_one_more_epoch_and_no_set_up():
    drv = fake_trainer([6.0, 1.0, 0.5, 0.5])
    ctx = SimpleNamespace(driver=drv, units=40)
    assert read("loader_wait_ms.train", ctx) == pytest.approx(2.0)
    assert ctx.units == 44
    # an older loader without the counters, or a driver without a Trainer
    del drv.trainer.train_loader.waits
    assert read("loader_wait_ms.train", ctx) is None and ctx.units == 44
    assert read("loader_wait_ms.train", SimpleNamespace(
        driver=SimpleNamespace())) is None


def test_a_gap_is_labelled_by_its_ending_work_s_launch():
    """Kernel 2 is launched in stage 1 and waits for an event until 80 us:
    the gap it ends is stage 1's, though the host is in stage 2 by
    then, where the time just before the gap's end points."""
    sp = spans(("hybrid", 0, 100, -1), ("hybrid.stage1", 10, 40, 0),
               ("hybrid.stage2", 50, 90, 0))
    evs = events(("kernel", 30, 5, 20), ("kernel", 80, 5, 25))
    st = span_trace(sp, evs, units=1)
    assert st.labelled_gaps()[:2] == [
        ["hybrid.stage1 (gap ending at 0.080 ms)", pytest.approx(45e-6)],
        ["hybrid.stage1 (gap ending at 0.030 ms)", pytest.approx(30e-6)]]
    ctx = ctx_with(st)
    assert read("dispatch_gap_ms.patch", ctx) == pytest.approx(0.075)
    by_time = Trace(kernels=[("k", 30, 5), ("k", 80, 5)],
                    spans=[(s.name, s.start_ns / 1e3, s.end_ns / 1e3)
                           for s in sp], start_us=0.0, end_us=100.0)
    assert by_time.span_at(80 - 5.0) == "hybrid.stage2"


def test_a_stretch_whose_device_clock_ran_off_is_profiled_again(
        monkeypatch):
    good = span_trace(PATCH_SPANS, PATCH_WORK)
    assert good.device_over_host() == pytest.approx((125 - 8) / 130)
    # every device time halved: the card's work spans under half the host's
    bad = span_trace(PATCH_SPANS, [
        {**e, "ts": e["ts"] / 2, "dur": e["dur"] / 2}
        if e["cat"] != "cuda_runtime" else e for e in PATCH_WORK])
    assert bad.device_over_host() < program_spans.MIN_DEVICE_OVER_HOST
    given = [bad, good]
    monkeypatch.setattr(program_spans, "_profiled_units",
                        lambda ctx, record: given.pop(0))
    ctx = SimpleNamespace(device="cuda", stretch=Trace())
    assert program_spans.stretch(ctx) is good and not given
    given = [bad] * program_spans.TRIES  # kept as read after the last try
    ctx = SimpleNamespace(device="cuda", stretch=Trace())
    assert program_spans.stretch(ctx) is bad and not given


def test_no_recorder_no_card_or_no_trace_reads_nothing(monkeypatch):
    from superresolution_tpu_torch.utils import profiling

    traced = SimpleNamespace(device="cuda", stretch=Trace())
    monkeypatch.delattr(profiling, "record")  # a tree before the spans
    assert program_spans.stretch(traced) is None
    for name in NEW - {"loader_wait_ms.train"}:
        assert read(name, SimpleNamespace(
            device="cuda", stretch=Trace(),
            driver=SimpleNamespace(training=True))) is None
    monkeypatch.undo()
    assert program_spans.stretch(SimpleNamespace(
        device="cpu", stretch=Trace())) is None
    assert program_spans.stretch(SimpleNamespace(
        device="cuda", stretch=None)) is None


def _stretch():
    """A profiled stretch as tracing.profile leaves it: two patches."""
    ks = [(f"void_conv_engine::tc::conv_tc_kernel<DenseConv{i}>",
           10.0 + 40 * i, 20.0) for i in range(2)]
    ks += [("hab_kernel<96>", 35.0, 3.0), ("flash_kernel<96>", 75.0, 2.0),
           ("void at::native::roll_cuda_kernel", 90.0, 4.0)]
    return Trace(kernels=ks, copies=[("Memcpy HtoD", 2.0, 1.0)],
                 spans=[("patch", 0.0, 50.0), ("patch", 50.0, 100.0)],
                 start_us=0.0, end_us=100.0)


@pytest.mark.parametrize("name", ["hybrid_astro.patch_b1",
                                  "hybrid_astro.train_b4",
                                  "esrgan_x4.tiled_2k",
                                  "hybrid_astro.upscale_1k"])
def test_the_other_readers_read_the_same_with_program_spans(name):
    cell = common.cell_files(name)
    train = name.endswith("train_b4")
    drv = SimpleNamespace(training=train, model_pixels=lambda: 128 * 128,
                          model_flops=lambda: 1e11)
    ctx = SimpleNamespace(
        cell=cell, config=cell["config_data"], traffic=cell["traffic_data"],
        device="cuda", stretch=_stretch(), stretch_units=2, window_s=1.0,
        window_units=20, work=10.0, latencies=[0.03, 0.05, 0.04],
        setup_s=3.0, extra={"data_wait_ms": 9.0, "trunk_ms": 500.0,
                            "tail_ms": 27.0}, driver=drv)
    e2e, layer = common.cell_metrics(common.benchmark(), name)
    others = [m["name"] for m in e2e + layer if m["name"] not in NEW]
    new = [m["name"] for m in layer if m["name"] in NEW]
    assert new and [m["name"] for m in layer][-len(new):] == new

    def values():
        return json.dumps({n: read(n, ctx) for n in others})

    before = values()
    # the program's spans over the same units: a stage, a step, a tiler
    ctx.program_spans = span_trace(spans(
        *PATCH_ROWS, ("train.step", 200, 300, -1),
        ("train.forward", 210, 230, 3), ("train.backward", 230, 260, 3),
        ("train.optimizer", 270, 290, 3), ("tiler", 400, 500, -1),
        ("tiler.gather", 410, 420, 7), ("tiler.scatter", 430, 440, 7)),
        PATCH_WORK)
    trained = fake_trainer([1.0, 3.0])
    drv.trainer, drv.run_unit = trained.trainer, trained.run_unit
    ctx.units = 0
    assert all(read(n, ctx) is not None for n in new)
    assert values() == before


def test_a_traced_run_without_a_card_reads_no_span_metric():
    """The harness's whole traced run on the CPU (its look for a card
    skipped): the span readers read nothing, and the loader's counter,
    a host clock, reads the Trainer's loader over one more epoch."""
    out = run.run_cell(tiny_cell("hybrid_astro.train_b4"), 2 ** 31 + 7,
                       0.2, True, device="cpu")
    assert out["correct"], out["checks"]
    got = set(out["metrics"]) & NEW
    assert got == {"loader_wait_ms.train"}
    assert out["metrics"]["loader_wait_ms.train"]["value"] >= 0
