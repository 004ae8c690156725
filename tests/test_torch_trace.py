"""The port's spans (`e3dge_torch.utils.trace`) on the CPU at the tiny
configuration: nothing opened without a profiler; under one, every layer
boundary of an inversion and of a stage-2.2 iteration among the profiler's
host operators, nested as the layers are; under a CUDA graph capture each
span cuts the capture at its entry and exit; and `Layers`' join of spans
with device operations against values computed by hand."""

from collections import Counter
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from e3dge_torch import config as tc
from e3dge_torch.models.discriminator import Discriminator
from e3dge_torch.models.e3dge import E3DGE, LatentMeans
from e3dge_torch.runner import Runner
from e3dge_torch.training import data as tdata
from e3dge_torch.training import steps as ts
from e3dge_torch.utils import trace
from e3dge_torch.utils.weights import init_weights

INVERSION = {"inversion": 1, "e0.encoder": 1, "e0.pose": 1, "g0.render": 2, "e1.filter": 2, "e1.fusion": 1,
             "g1.decoder": 1}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = tc.tiny_full_config()
    model = E3DGE(cfg, device="cpu")
    init_weights(model, 0)
    rng = np.random.RandomState(0)
    ml = LatentMeans(
        torch.from_numpy((0.2 * rng.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim)).astype(np.float32)),
        torch.from_numpy((0.2 * rng.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim)).astype(np.float32)))
    photos = torch.from_numpy(rng.uniform(-1, 1, (1, 3, cfg.pifu.load_size, cfg.pifu.load_size)).astype(np.float32))
    return cfg, model, ml, photos


def traced(fn):
    """(the port's spans, every host operator) of fn run under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    _, host = trace.read(prof)
    return [h for h in host if h[2] in trace.LAYERS], host


def within(inner, outer) -> bool:
    return outer[0] <= inner[0] <= inner[1] <= outer[1]


def test_span_without_a_profiler_is_one_shared_object():
    assert not torch._C._autograd._profiler_enabled()
    a, b = trace.span("e.step"), trace.span("g0.render")
    assert a is b
    with a, b:
        pass


@pytest.mark.parametrize("name", trace.LAYERS + (trace.REPLAY, trace.CAPTURE))
def test_span_off_the_profiler_and_outside_a_capture_is_the_shared_null_context(name):
    assert trace._cut is None and not torch._C._autograd._profiler_enabled()
    assert trace.span(name) is trace._OFF and trace.mark(name) is trace._OFF


def test_under_a_capture_each_span_of_an_inversion_cuts_it(tiny, monkeypatch):
    """While `utils.graphs` captures, `span` hands each span to the capture's
    cut (here a recorder of the entries and exits): an inversion's spans
    arrive in order, each exit matching its entry, and none opens a profiler
    range by itself."""
    cfg, model, ml, photos = tiny
    runner = Runner(model, ml, device="cpu")
    steps = []

    @contextmanager
    def cut(name):
        steps.append(("enter", name))
        yield
        steps.append(("exit", name))

    monkeypatch.setattr(trace, "_cut", cut)
    runner.image2image(photos)
    monkeypatch.setattr(trace, "_cut", None)
    assert Counter(n for kind, n in steps if kind == "enter") == INVERSION
    stack = []
    for kind, name in steps:
        if kind == "enter":
            stack.append(name)
        else:
            assert stack.pop() == name
    assert not stack and steps[0] == ("enter", "inversion") and steps[-1] == ("exit", "inversion")
    assert [n for kind, n in steps if kind == "enter"][1:4] == ["e0.encoder", "e0.pose", "g0.render"]


def test_an_inversion_opens_every_layer_inside_its_request(tiny):
    cfg, model, ml, photos = tiny
    runner = Runner(model, ml, device="cpu")
    runner.image2image(photos)
    spans, host = traced(lambda: runner.image2image(photos))
    assert Counter(n for _, _, n in spans) == INVERSION
    (inv,) = [s for s in spans if s[2] == "inversion"]
    assert all(within(s, inv) for s in spans)
    (fusion,) = [s for s in spans if s[2] == "e1.fusion"]
    assert sum(within(s, fusion) for s in spans if s[2] == "e1.filter") == 1
    # the spans share the profiler's timeline: each layer's own operators lie inside it
    (enc,) = [s for s in spans if s[2] == "e0.encoder"]
    convs = [h for h in host if h[2] == "aten::conv2d" and within(h, inv)]
    assert convs and any(within(h, enc) for h in convs)
    assert not any(within(h, enc) for h in host if h[2] == "aten::grid_sampler_2d")


def test_a_training_iteration_opens_its_layers(tiny, tmp_path):
    cfg, model, ml, _ = tiny
    rng = np.random.RandomState(3)
    for i in range(4):
        Image.fromarray((rng.rand(16, 16, 3) * 255).astype(np.uint8)).save(tmp_path / f"{i}.png")
    reals = tdata.ImageFolderDataset(tmp_path, size=16, thumb_size=8, rng=np.random.RandomState(7)).iter_batches(2, 0)
    state = ts.create_train_state(model, ts.STAGE22_TRAINABLE, 1e-4, ema=True)
    e_step = ts.make_cycle_step(model, dict(l2_lambda=1.0), state)
    d_state = ts.create_d_state(Discriminator(16, channel_multiplier=1, channel_base=32), 1e-4)
    d_step = ts.make_full_d_step(dict(r1=10.0), d_state, d_reg_every=1)
    gen = torch.Generator().manual_seed(0)

    def iteration():
        fakes, _ = ts.full_d_batch(model, ml, 2, 16, gen)
        d_step(torch.from_numpy(next(reals)["image"]), fakes)
        e_step(ml, 2, gen)

    spans, _ = traced(iteration)
    top = [s for s in spans if not any(within(s, o) for o in spans if o is not s)]
    assert [n for _, _, n in sorted(top)] == ["d.producer", "data.reals", "d.step", "e.step"]
    (step,) = [s for s in spans if s[2] == "e.step"]
    inside = sorted(s for s in spans if s is not step and within(s, step))
    assert [n for _, _, n in inside][-2:] == ["e.backward", "e.optimizer"]
    # the cycle step's forward runs the serving layers inside it
    assert {"g0.render", "e1.fusion", "g1.decoder"} <= {n for _, _, n in inside}


@pytest.fixture(scope="module")
def tiny_stage1():
    """A stage-1 step at tiny_test_config (E0 trained, the shape terms with
    the normal and eikonal lambdas on) and its mean latents."""
    torch.manual_seed(1)
    cfg = tc.tiny_test_config()
    model = E3DGE(cfg, device="cpu")
    init_weights(model, 1)
    ml = LatentMeans(0.2 * torch.randn(1, cfg.renderer.depth + 1, cfg.renderer.style_dim),
                     0.2 * torch.randn(1, cfg.decoder.n_latent, cfg.decoder.style_dim))
    state = ts.create_train_state(model, ts.STAGE1_TRAINABLE, 1e-4)
    return ts.make_stage1_step(model, dict(ts.STAGE1_LAMBDAS), state), ml


def test_a_stage1_step_opens_its_layers_nested(tiny_stage1):
    """The step's spans: "e.step" around it all; inside it "e.sample" (the
    frozen GAN's render, G0 and G1) before the loss, "g0.shape" after the
    inversion's layers and outside the sample, then "e.backward" and
    "e.optimizer"."""
    step, ml = tiny_stage1
    spans, _ = traced(lambda: step(ml, 2, torch.Generator().manual_seed(0)))
    (top,) = [s for s in spans if not any(within(s, o) for o in spans if o is not s)]
    assert top[2] == "e.step"
    (sample,) = [s for s in spans if s[2] == "e.sample"]
    (shape,) = [s for s in spans if s[2] == "g0.shape"]
    assert within(sample, top) and within(shape, top) and not within(shape, sample)
    in_sample = {n for s, e, n in spans if (s, e, n) != sample and within((s, e), sample)}
    assert in_sample == {"g0.render", "g1.decoder"}
    after = [n for s, _, n in sorted(spans) if s > shape[1]]
    assert after == ["e.backward", "e.optimizer"]
    # the inversion's encoder, render and decoder lie between the sample and the shape terms
    between = {n for s, e, n in spans if sample[1] < s and e < shape[0]}
    assert {"e0.encoder", "g0.render", "g1.decoder"} <= between
    assert not {n for s, e, n in spans if (s, e, n) != shape and within((s, e), shape)}


def test_a_stage1_step_without_a_profiler_opens_nothing(tiny_stage1, monkeypatch):
    step, ml = tiny_stage1
    asked = []

    def recorded(name):
        out = trace.span(name)
        asked.append((name, out is trace._OFF))
        return out

    monkeypatch.setattr(ts, "span", recorded)
    step(ml, 2, torch.Generator().manual_seed(0))
    assert {n for n, _ in asked} == {"e.step", "e.sample", "g0.shape", "e.backward", "e.optimizer"}
    assert all(off for _, off in asked)


def test_a_cycle_step_opens_no_stage1_span(tiny):
    cfg, model, ml, _ = tiny
    state = ts.create_train_state(model, ts.STAGE22_TRAINABLE, 1e-4)
    e_step = ts.make_cycle_step(model, dict(l2_lambda=1.0), state)
    spans, _ = traced(lambda: e_step(ml, 2, torch.Generator().manual_seed(0)))
    names = {n for _, _, n in spans}
    assert "e.step" in names and not names & {"e.sample", "g0.shape"}


def op(start, end, host):
    return ("kernel", start, end, host)


# two inversions; the first nests E1's filter in its fusion
HOST = [
    (100, 4100, "inversion"), (200, 600, "e0.encoder"), (250, 350, "aten::conv2d"), (700, 1200, "g0.render"),
    (1300, 3000, "e1.fusion"), (1500, 2500, "e1.filter"), (3100, 3500, "g0.render"), (3600, 4000, "g1.decoder"),
    (5000, 6000, "inversion"), (5100, 5500, "g0.render"), (5600, 5900, "e1.fusion"),
]
OPS = [
    op(310, 400, 300), op(810, 1100, 800), op(1120, 1190, None),  # E0; G0 and a kernel linked to no call
    op(1400, 1450, 1400), op(1610, 2600, 1600), op(2700, 2720, 2700),  # fusion; its filter; fusion
    op(3200, 3300, 3200), op(3700, 4050, 3700),  # G0; G1 (running on after its span closed)
    op(4500, 4600, 4500), op(5200, 5400, 5200), op(5700, 5750, 5700),  # outside every span; G0; fusion
]


@pytest.mark.parametrize("name, own", [
    ("g0.render", (290 + 70 + 100 + 200, 4)),  # the unlinked kernel follows the G0 kernel before it
    ("e1.fusion", (50 + 20 + 50, 3)),  # the nested filter's 990 is not the fusion's
    ("e1.filter", (990, 1)),
    ("e0.encoder", (90, 1)),
    ("inversion", (0, 0)),
    (None, (100, 1)),
])
def test_layers_give_each_operation_to_the_innermost_span_at_its_launch(name, own):
    lay = trace.Layers(OPS, HOST)
    assert (lay.device_ns(name), len(lay.own[name])) == own


def test_layers_read_host_and_idle_time_of_the_spans():
    lay = trace.Layers(OPS, HOST)
    assert lay.names == set(INVERSION) - {"e0.pose"}
    assert lay.host_ns("g0.render") == 500 + 400 + 400
    # request 1: 4000 open, busy 90 + 290 + 70 + 50 + 990 + 20 + 100 + 350 (to 4050); request 2: 1000, busy 250
    assert lay.idle_ns({"inversion"}) == (4000 - 1960) + (1000 - 250)
    rows = lay.table()
    assert set(rows) == lay.names | {None}
    # innermost [1500, 2500], busy from 1610 on
    assert rows["e1.filter"] == (990, 1, 110)
    # innermost [100, 200], [600, 700], [1200, 1300], [3000, 3100], [3500, 3600], [4000, 4100], [5000, 5100],
    # [5500, 5600], [5900, 6000]: busy 50 of [4000, 4100]
    assert rows["inversion"] == (0, 0, 900 - 50)


@pytest.mark.parametrize("names, ns", [
    ({"e1.fusion"}, 50 + 990 + 20 + 50),  # the nested filter's 990 is the fusion's too
    ({"g0.render"}, 290 + 70 + 100 + 200),  # the unlinked kernel follows the G0 kernel before it
    ({"inversion"}, sum(e - s for _, s, e, _ in OPS) - 100),  # all but the kernel outside every span
    ({"e0.encoder", "g1.decoder"}, 90 + 350),
    ({"e.sample"}, 0),
])
def test_layers_read_the_device_time_launched_inside_spans(names, ns):
    assert trace.Layers(OPS, HOST).inclusive_ns(names) == ns


def test_layers_without_the_ports_spans_hold_nothing():
    lay = trace.Layers(OPS, [h for h in HOST if h[2] == "aten::conv2d"])
    assert lay.names == set() and lay.device_ns(None) == sum(e - s for _, s, e, _ in OPS)
