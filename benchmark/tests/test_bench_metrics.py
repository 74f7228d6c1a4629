"""The benchmark's arithmetic: the window's rate and tail, busy time, the
FLOP count against BASELINE.md's audit, and the least-time count against
the port's ``chip_smoke.bound_ms``."""

import itertools

import pytest
import torch

from benchmark.harness import flops, roofline
from benchmark.harness.trace import busy_and_span, merged
from benchmark.harness.window import Window, percentile

N1024 = {"sample_num": 1024, "img_size": 192, "sa_npoints": (512, 256, 128, 64),
         "num_category": 6, "freeze_world_enhancer": False,
         "backbone": "resnet18"}


def _window(latencies, gap=0.0):
    """A window over items of the given seconds, ``gap`` between items."""
    now = [0.0]
    w = Window(seconds=1e9, clock=lambda: now[0])
    w.open()
    for lat in latencies:
        w.item()
        now[0] += lat
        w.done(2)
        now[0] += gap
    return w


def test_a_stall_moves_the_rate_and_the_tail():
    steady = _window([0.02] * 100)
    stalled = _window([0.02] * 94 + [0.5] * 6)
    assert steady.rate() == pytest.approx(200 / 2.0)
    assert stalled.rate() == pytest.approx(200 / (94 * 0.02 + 3.0))
    assert steady.p95_ms() == pytest.approx(20.0)
    assert stalled.p95_ms() == pytest.approx(500.0)


def test_the_rate_counts_the_whole_window():
    w = _window([0.01] * 10, gap=0.09)
    # ten items of 10 ms, 90 ms apart: the window ends at the last item
    assert w.length == pytest.approx(10 * 0.01 + 9 * 0.09)
    assert w.rate() == pytest.approx(20 / w.length)


@pytest.mark.parametrize("values,q,want", [
    ([1, 2, 3, 4], 50, 2), (list(range(1, 101)), 95, 95),
    (list(range(1, 21)), 95, 19), ([7], 95, 7)])
def test_percentile_is_nearest_rank(values, q, want):
    assert percentile(values, q) == want


@pytest.mark.parametrize("ivs,busy,extent", [
    ([(0, 1), (2, 3)], 2, 3), ([(0, 2), (1, 3)], 3, 3),
    ([(5, 6), (0, 1), (0.5, 0.7)], 2, 6), ([(0, 10), (2, 3)], 10, 10)])
def test_busy_and_span(ivs, busy, extent):
    assert busy_and_span(ivs) == (busy, extent)
    assert sum(e - s for s, e in merged(ivs)) == busy


def test_flops_agree_with_the_audit():
    """BASELINE.md's rows: the encoder's ten rows sum to 33.49 GFLOP, the
    PointNet2MSG's SA + FP to 0.93 + 0.54. Its "~1.3" for the deformer and
    the pose head undercounts them (1.27 + 1.49 counted layer by layer
    here), so the total is held to within 5% of its ~36.4."""
    assert flops.encoder(192) / 1e9 == pytest.approx(33.49, rel=2e-3)
    assert flops.pointnet(1024, N1024["sa_npoints"]) / 1e9 == pytest.approx(
        0.93 + 0.54, rel=1e-2)
    assert flops.forward(N1024) / 1e9 == pytest.approx(36.4, rel=0.05)


def test_train_flops():
    fwd = flops.forward(N1024)
    extra = flops.light(1024) + flops.pointnet(1024, N1024["sa_npoints"]) \
        + flops.heavy(1024)
    assert flops.train_sample(N1024) == pytest.approx(3 * (fwd + extra))
    frozen = {**N1024, "freeze_world_enhancer": True}
    assert flops.train_sample(frozen) == pytest.approx(
        3 * (fwd + flops.light(1024))
        + flops.pointnet(1024, N1024["sa_npoints"]))


def _cases():
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(2, 256, 3, generator=g)
    cen = xyz[:, :64].contiguous()
    feats = torch.rand(2, 256, 16, generator=g)
    idx = [torch.randint(0, 256, (2, 64, ns), generator=g, dtype=torch.int32)
           for ns in (16, 32)]
    grads = [torch.rand(2, 64, ns, 19, generator=g) for ns in (16, 32)]
    depth = torch.rand(1, 48, 64, generator=g) * (torch.rand(1, 48, 64) > 0.3)
    fmap = torch.rand(2, 12, 12, 64, generator=g).to(torch.bfloat16)
    rows = torch.rand(4, 64, generator=g)
    return [
        ("fps", (xyz, 64), torch.zeros(2, 64, dtype=torch.int32)),
        ("ball_query_group", ((0.1, 0.2), (16, 32), xyz, cen, feats),
         [torch.zeros(2, 64, ns, 19) for ns in (16, 32)]),
        ("ball_query", ((0.1, 0.2), (16, 32), xyz, cen), idx),
        ("fp_interpolate", (xyz, cen, feats[:, :64]), torch.zeros(2, 256, 16)),
        ("three_nn", (xyz, cen), (torch.zeros(2, 256, 3),
                                  torch.zeros(2, 256, 3, dtype=torch.int32))),
        ("group_scatter", (idx, grads, 256), (torch.zeros(2, 256, 19),
                                              torch.zeros(2, 64, 3))),
        ("interp_scatter", (torch.rand(2, 256, 16), idx[0][:, :, :3],
                            torch.rand(2, 256, 3), 64), torch.zeros(2, 64, 16)),
        ("depth_fill", (depth,), torch.zeros_like(depth)),
        ("bn_eval", (fmap, rows, "relu", fmap, None), torch.zeros_like(fmap)),
    ]


@pytest.mark.parametrize("name,args,out", _cases(), ids=lambda c: str(c)[:20])
def test_least_time_agrees_with_chip_smoke(name, args, out):
    chip_smoke = pytest.importorskip("chip_smoke")
    nbytes, f32, mma, valid = roofline.bound_parts(name, args, out)
    if valid is not None:
        f32 += 442.0 * float(valid)
    assert roofline.least_ms(nbytes, f32, mma) == pytest.approx(
        max(chip_smoke.bound_ms(name, args, out)), rel=1e-12)


def test_kernel_names_come_from_the_sources():
    names = roofline.kernel_names()
    assert {"fps_kernel", "bq_group_kernel", "fp_interp_kernel", "sa_kernel",
            "stage_a", "stage_b", "gemm_bf16_kernel"} <= names
    assert not any(n.startswith("__") for n in names)


def test_unknown_kernel_is_held_to_its_bytes():
    t = torch.zeros(1000)
    nbytes, f32, mma, _ = roofline.bound_parts("a_new_kernel", (t,), t)
    assert (nbytes, f32, mma) == (8000, 0.0, 0.0)


def test_every_kernel_of_the_program_has_a_formula():
    from istnet_tpu_torch.ops import dispatch
    assert set(dispatch.KERNELS) <= roofline.FORMULAS
    assert {name for name, _, _ in _cases()} <= roofline.FORMULAS


@pytest.mark.parametrize("name", sorted(roofline.FORMULAS))
def test_a_kernel_called_with_other_arguments_raises(name):
    """A formula never falls back to the bytes alone: the count would
    change meaning unseen."""
    with pytest.raises((IndexError, AttributeError, TypeError, ValueError)):
        roofline.bound_parts(name, (), torch.zeros(4))


def test_the_meter_lets_a_layout_mismatch_raise(monkeypatch):
    from istnet_tpu_torch.ops import dispatch
    fn = dispatch.wrapper("fps")
    meter = roofline.KernelMeter()
    wrapped = meter._wrap("fps", lambda *a, **k: torch.zeros(2, 4))
    with pytest.raises((IndexError, TypeError)):
        wrapped(npoint=4)
    assert dispatch.wrapper("fps") is fn
    unknown = meter._wrap("a_new_kernel", lambda *a, **k: torch.zeros(4))
    unknown(torch.zeros(4), scale=torch.zeros(4))
    assert meter.bytes_only == {"a_new_kernel"}
    assert meter.finish() == pytest.approx(48 / roofline.HBM_BPS * 1e3)


TWINS = [("device.idle_share.train", "device.idle_share.infer"),
         ("device.idle_share.batch", "device.idle_share.infer"),
         ("kernels.roofline_share.train", "kernels.roofline_share.infer"),
         ("kernels.roofline_share.batch", "kernels.roofline_share.infer"),
         ("forward.device_ms_per_pose.batch", "forward.device_ms_per_pose"),
         ("mfu.batch", "mfu.infer")]


@pytest.mark.parametrize("twin,original", TWINS)
def test_a_twin_reader_reads_as_its_original(twin, original):
    from benchmark.harness import manifest
    assert manifest.reader(twin).read is manifest.reader(original).read


def test_host_readings_count_the_collector():
    import gc
    from benchmark.harness.window import HostReadings
    with HostReadings() as host:
        gc.collect()
        sum(i * i for i in range(10000))
    r = host.readings
    assert r["gc"]["2"][0] >= 1 and r["gc"]["2"][1] >= 0.0
    assert r["thread_cpu_s"] > 0.0
    assert r["involuntary_switches"] >= 0
    assert gc.callbacks.count(host._on_gc) == 0


@pytest.mark.gpu
def test_device_window_reads_busy_time_without_host_events(card):
    from benchmark.harness.trace import device_window
    out = {}
    x = torch.randn(2048, 2048, device=card)
    torch.cuda.synchronize(card)
    with device_window(out)():
        for _ in range(4):
            x = x @ x.T / 2048.0
        torch.cuda.synchronize(card)
    assert out["device_ops"] >= 4
    assert 0.0 < out["busy_s"] <= out["span_s"] <= out["window_s"]


def test_seeds_of_torch_stay_in_range():
    from benchmark.harness.weights import torch_seed
    for seed, stream in itertools.product((0, 2**31 + 5, 2**40, -3), (0, 7)):
        assert 0 <= torch_seed(seed, stream) < 2**63


class _Event:
    """A stand-in for the profiler's kineto event."""

    def __init__(self, name, start, dur, cuda=False, annotation=False):
        self._v = (name, start, dur, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._v[4]



def _trace():
    from benchmark.harness.trace import Trace
    return Trace([
        _Event("bench:window", 0, 1000, annotation=True),
        _Event("bench:forward", 100, 300, annotation=True),
        _Event("bench:fill", 500, 100, annotation=True),
        _Event("void fps_kernel<8>(float const*)", 300, 100, cuda=True),
        _Event("elementwise_kernel", 600, 50, cuda=True),
        _Event("elementwise_kernel", 900, 150, cuda=True),
        _Event("bench:forward", 300, 100, cuda=True, annotation=True),
        _Event("bench:fill", 600, 50, cuda=True, annotation=True)])


def test_trace_attribution():
    t = _trace()
    assert t.range_ms("forward") == pytest.approx(100e-6)
    assert t.range_ms("fill") == pytest.approx(50e-6)
    assert t.range_ms("preprocess") is None
    # the last kernel runs past the window's end: clipped to it
    busy, span = t.busy_and_span_s()
    assert busy == pytest.approx((100 + 50 + 100) * 1e-9)
    assert span == pytest.approx((1000 - 300) * 1e-9)
    assert t.kernels_ms({"fps_kernel"}) == pytest.approx(100e-6)
    assert t.kernel_count({"fps_kernel", "sa_kernel"}) == 1
    b = t.breakdown({"fps_kernel"})
    assert b["device_ops"][0][0] in ("fps_kernel", "elementwise_kernel")
    # gaps 650-900 (host outside the ranges), then 400-600 (host in fill)
    assert [g[0] for g in b["idle_gaps"]] == ["outside ranges", "fill"]
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx([250e-9, 200e-9])


def test_rotation_gaps_take_answers_with_no_posed_instance():
    """A frame whose instances were all dropped adds no rows."""
    from benchmark.harness.compare import rotation_gaps
    eye = torch.eye(3).expand(2, 3, 3)
    six = torch.tensor([[1.0, 0, 0, 0, 1, 0], [1, 0, 0, 1, 1, 0]])
    g = rotation_gaps([eye + 0.01, torch.zeros(0, 3, 3)],
                      [eye, torch.zeros(0, 3, 3)], [six, torch.zeros(0, 6)])
    # the second answer's vectors are 45 degrees apart
    assert g.tolist() == pytest.approx([0.01, 0.01 * 2 ** -0.5])
