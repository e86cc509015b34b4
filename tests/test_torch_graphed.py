"""infer/common.Graphed, the CUDA-graph replay of the fused hybrid's two
stages: on the CPU, its decisions with the capture stubbed (a pass-through
on CPU tensors and with autograd on, the key, the one graph it keeps, the
counters, outputs the caller owns), and the fused HAT's levers read when
the stage is built; on the card (marked `card`, skipped without one),
replay against the eager function on a small fused_hybrid_model. The
card tests import no JAX: run them on a machine with a GPU as

    python -m pytest tests/test_torch_graphed.py --noconftest -m card
"""

from types import SimpleNamespace

import pytest
import torch

from superresolution_tpu_torch.infer import common, fused_hat
from superresolution_tpu_torch.infer.common import Graphed, wants_graph
from superresolution_tpu_torch.infer.fused_hat import (
    fused_hybrid_model,
    make_fused_hat,
)
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.models.hybrid import HybridSR
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.ops import hab

# every lever make_fused_hat reads
LEVERS = ("SRTPU_LANE_PAD", "SRTPU_LANE_PAD_TO", "SRTPU_STRIP_HAB",
          "SRTPU_STRIP_RB", "SRTPU_XLA_CAB", "SRTPU_GATHER_OCA",
          "SRTPU_EINSUM_OCA")


def _fn(x):
    return torch.tanh(x * 3.0) + x.sum()


def _stub_capture(g, made):
    """Replace g's capture by one on the CPU that records the keys it
    captured: a static input and output, and a 'graph' whose replay
    runs the eager function from the one into the other."""
    def capture(x):
        made.append(g.key(x))
        x_in = x.clone()
        out = g._fn(x_in)
        g._graph = SimpleNamespace(replay=lambda: out.copy_(g._fn(x_in)))
        g._x_in, g._out = x_in, out

    g._capture = capture


def _no_capture(x):
    raise AssertionError("captured")


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_cpu_tensors_pass_through_bit_identical(mode):
    g = Graphed(_fn)
    g._capture = _no_capture
    x = torch.randn(2, 5, 7, 3, generator=torch.Generator().manual_seed(1))
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}[mode]
    with ctx():
        got = g(x)
    assert torch.equal(got, _fn(x))
    assert (g.captures, g.replays, g.eager) == (0, 0, 1)


def test_a_card_input_wants_a_graph_only_with_autograd_off():
    card = SimpleNamespace(device=torch.device("cuda", 0))
    host = torch.zeros(1)
    with torch.enable_grad():
        assert not wants_graph(card) and not wants_graph(host)
    with torch.no_grad():
        assert wants_graph(card) and not wants_graph(host)
    with torch.inference_mode():
        assert wants_graph(card) and not wants_graph(host)
    # autograd on: the eager function, uncaptured, even for a card input
    g = Graphed(lambda x: x)
    g._capture = _no_capture
    with torch.enable_grad():
        assert g(card) is card
    assert (g.captures, g.replays, g.eager) == (0, 0, 1)


def test_the_key_separates_shape_dtype_and_mode():
    x = torch.zeros(1, 8, 8, 1)
    with torch.no_grad():
        base = Graphed.key(x)
        keys = [base, Graphed.key(torch.zeros(1, 8, 16, 1)),
                Graphed.key(torch.zeros(2, 8, 8, 1)),
                Graphed.key(x.to(torch.bfloat16))]
    with torch.inference_mode():
        keys.append(Graphed.key(x))
    assert len(set(keys)) == len(keys) == 5
    with torch.no_grad():
        assert Graphed.key(torch.ones(1, 8, 8, 1)) == base


def test_one_graph_is_kept_and_the_counters_count(monkeypatch):
    monkeypatch.setattr(common, "wants_graph", lambda x: True)
    g = Graphed(_fn)
    made = []
    _stub_capture(g, made)
    a, b = torch.full((1, 4, 4, 1), 0.5), torch.full((1, 4, 6, 1), 0.25)
    with torch.no_grad():
        for x in (a, a, a):
            assert torch.equal(g(x), _fn(x))
        assert (g.captures, g.replays, g.eager) == (1, 2, 0)
        # another key drops the graph for a new one; the old key then
        # captures again
        for x in (b, b, a):
            assert torch.equal(g(x), _fn(x))
        assert (g.captures, g.replays) == (3, 3)
        assert made == [g.key(a), g.key(b), g.key(a)]
        assert g._key == g.key(a) and g._x_in.shape == a.shape
    monkeypatch.setattr(common, "wants_graph", lambda x: False)
    g(a)
    assert (g.captures, g.replays, g.eager) == (3, 3, 1)


def test_an_output_is_the_caller_s_not_the_graph_s(monkeypatch):
    monkeypatch.setattr(common, "wants_graph", lambda x: True)
    g = Graphed(_fn)
    _stub_capture(g, [])
    a, b = torch.full((1, 4, 4, 1), 0.5), torch.full((1, 4, 4, 1), 0.25)
    with torch.no_grad():
        ya = g(a)
        kept = ya.clone()
        yb = g(b)
    assert (g.captures, g.replays) == (1, 1)
    assert torch.equal(ya, kept) and torch.equal(yb, _fn(b))
    for y in (ya, yb):
        assert y.data_ptr() != g._out.data_ptr()


def test_stages_share_their_first_stage_s_pool_and_stream():
    s1 = Graphed(_fn)
    s2 = Graphed(_fn, share=s1)
    assert s2._owner is s1 and s1._owner is s1


S1 = dict(scale=2, in_channels=1, out_channels=1, features=16, num_blocks=1,
          growth=8, upsampler="pixelshuffle")
HAT = dict(scale=2, in_channels=1, out_channels=1, embed_dim=12,
           depths=(2, 2), num_heads=(3, 3), window_size=4, upsample_feat=8)


def test_the_fused_hybrid_runs_both_stages_through_graphed_wrappers():
    torch.manual_seed(0)
    hybrid = HybridSR(RRDBNet(**S1, device="cpu"),
                      HATLite(**HAT, device="cpu"), output_size=32)
    model = fused_hybrid_model(hybrid.state_dict(), hybrid, device="cpu")
    s1, s2 = model.graphed
    assert s2._owner is s1
    x = torch.rand(1, 8, 8, 1)
    with torch.inference_mode():
        y = model(x)
    assert y.shape == (1, 32, 32, 1)
    assert [(g.captures, g.replays, g.eager) for g in model.graphed] == \
        [(0, 0, 1), (0, 0, 1)]


@pytest.mark.parametrize("lever", ["SRTPU_XLA_CAB", "SRTPU_STRIP_HAB",
                                   "SRTPU_EINSUM_OCA"])
def test_the_fused_hat_keeps_the_levers_it_was_built_with(lever,
                                                          monkeypatch):
    """A lever set after make_fused_hat built the stage, or unset after,
    changes nothing: the stage reads its levers once, so a graph of it
    cannot hold a stale one."""
    for v in LEVERS:
        monkeypatch.delenv(v, raising=False)
    torch.manual_seed(1)
    hat = HATLite(**HAT, device="cpu")
    calls = []
    for name in ("_cab_plain", "strip_hab_block",
                 "reference_window_attention"):
        real = getattr(fused_hat, name)
        monkeypatch.setattr(fused_hat, name, lambda *a, _n=name, _r=real,
                            **k: calls.append(_n) or _r(*a, **k))
    x = torch.rand(1, 8, 8, 1)
    plain = make_fused_hat(hat.state_dict(), hat, device="cpu")
    monkeypatch.setenv(lever, "1")
    levered = make_fused_hat(hat.state_dict(), hat, device="cpu")
    plain(x)
    assert calls == []
    monkeypatch.delenv(lever)
    levered(x)
    assert calls and set(calls) == {{
        "SRTPU_XLA_CAB": "_cab_plain", "SRTPU_STRIP_HAB": "strip_hab_block",
        "SRTPU_EINSUM_OCA": "reference_window_attention"}[lever]}


# ---- on the card --------------------------------------------------------

CARD_S1 = dict(scale=2, in_channels=1, out_channels=1, features=64,
               num_blocks=1, growth=32, upsampler="pixelshuffle")
CARD_HAT = dict(scale=2, in_channels=1, out_channels=1, embed_dim=96,
                depths=(2,), num_heads=(6,), window_size=8)


@pytest.fixture
def card_hybrid(monkeypatch):
    """A small fused_hybrid_model in bf16 on the card (32^2 -> 128^2;
    stage 2 at kernels 7-9's widths), its inputs, and its HybridSR."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for v in LEVERS:
        monkeypatch.delenv(v, raising=False)
    gen = torch.Generator().manual_seed(3)
    hybrid = HybridSR(RRDBNet(**CARD_S1, generator=gen, device="cuda"),
                      HATLite(**CARD_HAT, generator=gen, device="cuda"),
                      output_size=128).to(torch.bfloat16).eval()
    model = fused_hybrid_model(hybrid.state_dict(), hybrid)
    xs = [torch.rand((1, 32, 32, 1), generator=gen).to("cuda",
                                                      torch.bfloat16)
          for _ in range(3)]
    return model, xs, hybrid


def _eager(model, x):
    with torch.enable_grad():  # autograd on: no graph
        return model(x)


@pytest.mark.card
def test_replay_equals_the_eager_function_bit_for_bit(card_hybrid):
    model, xs, _ = card_hybrid
    want = [_eager(model, x) for x in xs[:2]]
    with torch.inference_mode():
        got = [model(x) for x in xs[:2]]
        again = model(xs[0])
    assert [g.eager for g in model.graphed] == [2, 2]
    assert [(g.captures, g.replays) for g in model.graphed] == \
        [(1, 2), (1, 2)]
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert torch.equal(again, want[0])


@pytest.mark.card
def test_an_output_kept_from_call_one_is_unchanged_by_call_two(card_hybrid):
    model, xs, _ = card_hybrid
    with torch.inference_mode():
        y1 = model(xs[0])
        kept = y1.clone()
        y2 = model(xs[1])
        torch.cuda.synchronize()
        assert torch.equal(y1, kept) and not torch.equal(y1, y2)
        assert y1.data_ptr() != y2.data_ptr()


@pytest.mark.card
def test_a_second_shape_or_another_lever_captures_again(card_hybrid,
                                                        monkeypatch):
    model, xs, hybrid = card_hybrid
    s1, s2 = model.graphed
    with torch.inference_mode():
        model(xs[0])
        wide = torch.rand((1, 32, 48, 1), device="cuda").to(torch.bfloat16)
        model(wide)
        assert (s1.captures, s2.captures) == (2, 2)
        model(xs[0])  # one graph kept: the first shape captures again
        assert (s1.captures, s2.captures, s1.replays) == (3, 3, 0)
        model(xs[0])
        assert (s1.captures, s1.replays) == (3, 1)
    # a model built under a lever captures its own graphs, of that path
    monkeypatch.setenv("SRTPU_XLA_CAB", "1")
    cab = fused_hybrid_model(hybrid.state_dict(), hybrid)
    with torch.inference_mode():
        flipped = cab(xs[0])
    assert [g.captures for g in cab.graphed] == [1, 1]
    assert torch.equal(flipped, _eager(cab, xs[0]))  # the plain CAB
    assert not torch.equal(flipped, _eager(model, xs[0]))


@pytest.mark.card
def test_a_capture_launches_twice_and_a_replay_serves_every_call(
        card_hybrid):
    """The kernels' counters count host launches: the capturing call's
    warm-up and capture pass, and nothing for a replay, whose calls
    the wrappers' `replays` count (graph_share: 100%)."""
    model, xs, _ = card_hybrid
    ops = [hab.fused_hab_block, hab.fused_cab_convs]

    def counted(fn):
        for op in ops:
            op.launches = 0
        fn()
        return [op.launches for op in ops]

    eager = counted(lambda: _eager(model, xs[0]))
    assert eager == [2, 2]
    with torch.inference_mode():
        assert counted(lambda: model(xs[0])) == [2 * n for n in eager]
        before = [(g.captures, g.replays, g.eager) for g in model.graphed]
        assert counted(lambda: [model(x) for x in xs]) == [0, 0]
    calls = [(c - c0, r - r0, e - e0) for (c, r, e), (c0, r0, e0)
             in zip([(g.captures, g.replays, g.eager)
                     for g in model.graphed], before)]
    assert calls == [(0, 3, 0), (0, 3, 0)]
