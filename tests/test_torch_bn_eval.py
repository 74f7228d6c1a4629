"""The eval BatchNorm pass (``ops/bn_eval.py``, ``BatchNorm.norm_act``) on
the CPU: its plain version against the BatchNorm's own eval chain and its
consumer, bit for bit on NaN, +-inf and -0.0; dispatch of CPU tensors to
the plain version; the calls that keep the chain (training, float64, a
gradient to record) with their outputs and gradients; the cached rows
rebuilt when the statistics change; and the whole ISTNet eval forward
against the same forward with every BN on its chain, as it ran before the
pass."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from istnet_tpu_torch import ops
from istnet_tpu_torch.entry import build_model, make_inputs
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.ops import bn_eval, dispatch

TINY, IMG, NPTS = (32, 16, 8, 8), 48, 128
EPILOGUES = ["none", "relu", "add_relu", "prelu"]


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32 if t.element_size() == 4
                               else torch.int64)


def _same_bits(got, want) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(_bits(got), _bits(want)))


def _edge_values(rng, shape, dtype):
    """Normal values with NaN, +-inf, -0.0 and 0.0 sprinkled in."""
    a = (rng.randn(*shape) * 3).astype(np.float32)
    flat = a.reshape(-1)
    picks = rng.choice(flat.size, size=min(flat.size, 40), replace=False)
    flat[picks] = np.resize(np.array([np.nan, np.inf, -np.inf, -0.0, 0.0],
                                     np.float32), picks.size)
    return torch.from_numpy(a).to(dtype)


def _bn(c: int, seed: int) -> layers.BatchNorm:
    """An eval BatchNorm with random statistics and affine, a -0.0 bias
    every 5 channels and a zero scale every 7."""
    rng = np.random.RandomState(seed)
    bn = layers.BatchNorm(c).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.randn(c)))
        bn.running_var.copy_(torch.from_numpy(rng.rand(c) + 0.05))
        bn.weight.copy_(torch.from_numpy(rng.randn(c)))
        bn.bias.copy_(torch.from_numpy(rng.randn(c)))
        bn.bias[::5] = -0.0
        bn.weight[1::7] = 0.0
    return bn


def _case(dtype, epilogue, c, seed=0):
    """(bn, x, act, residual, slope) of one call site."""
    rng = np.random.RandomState(seed + c)
    shape = (2, 3, 5, c)
    x = _edge_values(rng, shape, dtype)
    residual = (_edge_values(rng, shape, dtype) if epilogue == "add_relu"
                else None)
    slope = torch.tensor([0.2371]) if epilogue == "prelu" else None
    act = {"none": None, "add_relu": "relu"}.get(epilogue, epilogue)
    return _bn(c, seed + 1), x, act, residual, slope


def _chain(bn, x, act=None, residual=None, slope=None):
    """The BatchNorm's forward and then its consumer, as separate ops."""
    y = bn(x)
    if act == "relu":
        return F.relu(y if residual is None else y + residual)
    return layers.prelu(y, slope) if act == "prelu" else y


@pytest.mark.parametrize("c", [3, 64, 130])
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_the_batchnorm_chain_and_its_consumer(dtype, epilogue, c):
    bn, x, act, residual, slope = _case(dtype, epilogue, c)
    with torch.no_grad():
        want = _chain(bn, x, act, residual, slope)
        got = bn_eval.plain(x, bn.eval_rows(), act, residual, slope)
        fused = bn.norm_act(x, act, residual, slope)
    assert _same_bits(got, want)
    assert _same_bits(fused, want)
    assert torch.isnan(x).any() and (x == float("inf")).any()


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_dispatch_sends_cpu_tensors_to_the_plain_version(epilogue):
    bn, x, act, residual, slope = _case(torch.bfloat16, epilogue, 64)
    ops.reset_launch_counts()
    rows = bn.eval_rows()
    got = dispatch.bn_eval(x, rows, act, residual, slope)
    assert _same_bits(got, bn_eval.plain(x, rows, act, residual, slope))
    empty = dispatch.bn_eval(x[:0], rows, act,
                             None if residual is None else residual[:0], slope)
    assert empty.shape == (0, *x.shape[1:])
    assert ops.launch_counts() == {name: 0 for name in dispatch.KERNELS}


def test_norm_act_on_the_cpu_goes_through_dispatch(monkeypatch):
    seen = []

    def spy(*args):
        seen.append(args[2:])
        return bn_eval.plain(*args)

    monkeypatch.setattr(dispatch, "bn_eval", spy)
    bn, x, act, residual, slope = _case(torch.float32, "add_relu", 64)
    with torch.inference_mode():
        bn.norm_act(x, act, residual, slope)
    assert len(seen) == 1 and seen[0][0] == "relu" and seen[0][1] is residual


KEEP_CHAIN = ([(case, e) for case in ("train", "float64", "grad_x", "grad_bn")
               for e in EPILOGUES]
              + [("grad_residual", "add_relu"), ("grad_slope", "prelu")])


@pytest.mark.parametrize("case,epilogue", KEEP_CHAIN)
def test_calls_that_keep_the_chain(monkeypatch, case, epilogue):
    """Training, a float64 map and a call that records a gradient (of the
    map, the BN's affine, the residual or the slope) never take the pass:
    the output, every gradient and the published batch statistics equal
    the chain's in their bits."""
    bn, x, act, residual, slope = _case(torch.float32, epilogue, 24, seed=3)
    x = torch.nan_to_num(x, nan=0.5, posinf=4.0, neginf=-4.0)
    if residual is not None:
        residual = torch.nan_to_num(residual, nan=0.5, posinf=4.0,
                                    neginf=-4.0)
    if case == "float64":
        bn, x = bn.double(), x.double()
        residual = None if residual is None else residual.double()
    bn.train(case == "train")
    bn.weight.requires_grad_(case == "grad_bn")
    bn.bias.requires_grad_(case == "grad_bn")
    x.requires_grad_(case in ("train", "grad_x"))
    if case == "grad_residual":
        residual.requires_grad_()
    if case == "grad_slope":
        slope.requires_grad_()
    leaves = [t for t in (x, residual, slope, bn.weight, bn.bias)
              if t is not None and t.requires_grad]
    assert leaves or case == "float64"

    def no_pass(*args):
        raise AssertionError("the eval pass ran")

    outs = []
    for run in (lambda: _chain(bn, x, act, residual, slope),
                lambda: bn.norm_act(x, act, residual, slope)):
        if outs:
            monkeypatch.setattr(dispatch, "bn_eval", no_pass)
        y = run()
        grads = torch.autograd.grad(y.sum(), leaves) if leaves else ()
        outs.append((y.detach(), grads, bn.batch_var))
    (y0, g0, v0), (y1, g1, v1) = outs
    assert _same_bits(y1, y0)
    assert len(g0) == len(g1) == len(leaves)
    for a, b in zip(g0, g1):
        assert _same_bits(a, b)
    if case == "train":
        assert v0 is not v1 and torch.equal(v0, v1)


def test_eval_rows_follow_the_statistics():
    """The pass's (4, C) rows are built once and rebuilt after
    ``load_state_dict``, an in-place edit of ``running_var`` and
    ``train()``."""
    bn = _bn(16, 5)

    def want():
        return torch.stack([bn.running_mean, bn.invstd(), bn.weight,
                            bn.bias]).detach()

    rows = bn.eval_rows()
    assert rows.dtype == torch.float32 and not rows.requires_grad
    assert torch.equal(rows, want()) and bn.eval_rows() is rows
    bn.load_state_dict(_bn(16, 6).state_dict())
    fresh = bn.eval_rows()
    assert fresh is not rows and torch.equal(fresh, want())
    with torch.no_grad():
        bn.running_var.mul_(2.0)
    again = bn.eval_rows()
    assert again is not fresh and torch.equal(again, want())
    bn.train()
    bn.eval()
    assert bn.eval_rows() is not again
    with torch.inference_mode():
        built = _bn(16, 7).eval_rows()
    assert not built.is_inference()


@pytest.mark.parametrize("layout,dense", [("contiguous", True),
                                          ("outer_permuted", True),
                                          ("channels_not_last", False),
                                          ("sliced", False),
                                          ("broadcast", False)])
def test_dense_channels_last_layouts(layout, dense):
    """The maps the kernel reads as flat memory, channel = offset mod C."""
    base = torch.zeros(4, 6, 5, 8)
    t = {"contiguous": base,
         "outer_permuted": base.permute(2, 0, 1, 3).contiguous()
                               .permute(1, 2, 0, 3),
         "channels_not_last": base.permute(0, 1, 3, 2),
         "sliced": base[:, :, :3],
         "broadcast": torch.zeros(1, 6, 5, 8).expand(4, 6, 5, 8)}[layout]
    assert bn_eval._dense_channels_last(t) is dense


@pytest.mark.parametrize("head", ["sparse", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_istnet_eval_forward_equals_the_chain_forward(monkeypatch, dtype,
                                                      head):
    """The tiny ISTNet's eval forward with the pass, bit for bit against
    the same forward with every BN on its own chain and its consumer (the
    forward before the pass)."""
    model = build_model("cpu", seed=2, sa_npoints=TINY)
    model.sparse_eval_head = head == "sparse"
    inputs = make_inputs(2, NPTS, IMG, seed=4, device="cpu")
    old = precision.compute_dtype()
    precision.set_compute_dtype(dtype)
    try:
        with torch.inference_mode():
            got = model(inputs)
            monkeypatch.setattr(layers.BatchNorm, "norm_act", _chain)
            want = model(inputs)
    finally:
        precision.set_compute_dtype(old)
    assert set(got) == set(want)
    for k in want:
        assert _same_bits(got[k], want[k]), k


@pytest.mark.parametrize("dtype,sites", [(torch.float32, 55),
                                         (torch.bfloat16, 37)])
def test_chip_smoke_records_every_call_site(dtype, sites):
    """``chip_smoke.bn_eval_cases`` (the card checks' and
    ``tools/bn_eval_torch.py``'s cases): one argument tuple a BN of a
    full-width eval forward, up_1's map among them permuted in memory, each
    reproducing the pass's output; the dispatch left as it was."""
    import chip_smoke

    real = dispatch.bn_eval
    cases = chip_smoke.bn_eval_cases(torch.device("cpu"), dtype, 1, 256)
    assert dispatch.bn_eval is real and len(cases) == sites
    assert any(not args[0].is_contiguous() for args in cases)
    acts = {(args[2], args[3] is not None) for args in cases}
    assert acts == {(None, False), ("relu", False), ("relu", True),
                    ("prelu", False)}
    for args in cases:
        assert args[0].dtype == dtype
        assert (args[2] == "prelu") == (args[4] is not None)
        out = bn_eval.plain(*args)
        assert out.shape == args[0].shape and out.dtype == dtype
