"""The pieces that make the card train step repeat bit for bit, on the CPU:
the PSP resize's backward as two fixed-order contractions, the per-point
gather as an indexed read, and cuDNN's deterministic mode scoped to the
step. Each is held to what it replaces: the resize to ``F.interpolate``
(forward equal, backward within 1e-6 of the largest gradient in float32,
1e-12 in float64), the gather to ``torch.gather`` (equal, repeated pixels
included). The card test ``test_card_train_step_repeats_bit_for_bit`` in
``tests/test_torch_gpu.py`` holds the whole step.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from istnet_tpu_torch.entry import build_train_model, make_train_batch
from istnet_tpu_torch.models.ist_net import gather_by_choose
from istnet_tpu_torch.nn import layers
from istnet_tpu_torch.train.train_state import (
    TrainConfig,
    deterministic_cudnn,
    make_optimizer,
    train_step,
)


@pytest.mark.parametrize("in_hw,out_hw", [((1, 1), (24, 24)), ((2, 2), (24, 24)),
                                          ((3, 3), (24, 24)), ((6, 6), (24, 24)),
                                          ((5, 3), (13, 20)), ((7, 7), (7, 7))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resize_backward_matches_interpolate(in_hw, out_hw, dtype):
    rng = np.random.RandomState(sum(in_hw) + sum(out_hw))
    x = torch.tensor(rng.randn(2, *in_hw, 5), dtype=dtype)
    g = torch.tensor(rng.randn(2, *out_hw, 5), dtype=dtype)
    got_x = x.clone().requires_grad_()
    got = layers.resize_bilinear(got_x, *out_hw)
    got.backward(g)
    want_x = x.clone().requires_grad_()
    want = F.interpolate(want_x.permute(0, 3, 1, 2), size=out_hw,
                         mode="bilinear", align_corners=False)
    want.permute(0, 2, 3, 1).backward(g)
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    scale = want_x.grad.abs().max()
    assert (got_x.grad - want_x.grad).abs().max() <= tol * scale
    with torch.no_grad():
        assert torch.equal(layers.resize_bilinear(x, *out_hw), got)


def test_matrices_first_cached_under_inference_mode_serve_a_backward():
    """The interpolation matrices are cached per shape, dtype and device; a
    serving forward under ``inference_mode`` that fills the cache first
    must not leave inference tensors for a later training step to save."""
    layers._cached_matrix.cache_clear()
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(2, 5, 7, 4), dtype=torch.float32)
    k = torch.tensor(rng.randn(3, 3, 4, 6), dtype=torch.float32)
    with torch.inference_mode():
        want = layers.conv3x3_on_doubled(x, k, None)
        layers.resize_bilinear_align_corners(x, 10, 14)
        layers.resize_bilinear(x, 10, 14)
    xg = x.clone().requires_grad_()
    got = layers.conv3x3_on_doubled(xg, k, None)
    (got.sum() + layers.resize_bilinear_align_corners(xg, 10, 14).sum()
     + layers.resize_bilinear(xg, 10, 14).sum()).backward()
    assert torch.equal(got.detach(), want)
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().max() > 0


def test_half_pixel_matrix_rows_are_the_interpolation():
    for n_in, n_out in ((1, 24), (3, 24), (6, 24), (5, 13)):
        a = layers._half_pixel_matrix(n_in, n_out)
        np.testing.assert_allclose(a.sum(1), 1.0, rtol=0, atol=1e-12)
        x = np.random.RandomState(n_in).randn(n_in)
        want = F.interpolate(torch.tensor(x)[None, None], size=n_out,
                             mode="linear", align_corners=False)[0, 0]
        np.testing.assert_allclose(a @ x, want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_by_choose_equals_torch_gather(dtype):
    """Forward and backward, a pixel chosen up to 5 times in a row."""
    rng = np.random.RandomState(3)
    fmap = torch.tensor(rng.randn(3, 8, 8, 6), dtype=dtype)
    choose = torch.from_numpy(rng.randint(0, 12, (3, 40)).astype(np.int32))
    g = torch.tensor(rng.randn(3, 40, 6), dtype=dtype)
    a = fmap.clone().requires_grad_()
    got = gather_by_choose(a, choose)
    got.backward(g)
    b = fmap.clone().requires_grad_()
    index = choose.long()[..., None].expand(-1, -1, 6)
    want = torch.gather(b.reshape(3, 64, 6), 1, index)
    want.backward(g)
    assert torch.equal(got, want)
    assert torch.equal(a.grad, b.grad)
    assert int(np.bincount(choose[0].numpy()).max()) >= 5


def test_deterministic_cudnn_is_scoped_to_the_step(monkeypatch):
    seen = []
    was = torch.backends.cudnn.deterministic
    with deterministic_cudnn():
        seen.append(torch.backends.cudnn.deterministic)
    assert seen == [True] and torch.backends.cudnn.deterministic == was

    import istnet_tpu_torch.train.train_state as ts

    real_loss = ts.step_loss

    def loss_seeing_the_flag(*args):
        seen.append(torch.backends.cudnn.deterministic)
        return real_loss(*args)
    monkeypatch.setattr(ts, "step_loss", loss_seeing_the_flag)
    cfg = TrainConfig()
    model = build_train_model("cpu", seed=2, sa_npoints=(16, 8, 8, 8))
    train_step(model, make_optimizer(model, cfg),
               make_train_batch(2, 64, 48, seed=1, device="cpu"), 0,
               torch.Generator().manual_seed(0), cfg)
    assert seen == [True, True]
    assert torch.backends.cudnn.deterministic == was
