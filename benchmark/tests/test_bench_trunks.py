"""The trunk a configuration names (``backbone``): ResNet-18's weights,
structure and FLOP counts as they were before the other trunks came in,
each trunk of the reference against the port's and against a counted
forward, the seeded weights of a deep trunk against float64, and the
arguments the program is built with."""

import copy
import hashlib
import json

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import flops, manifest, models, weights
from benchmark.reference import model as ref

TRUNKS = sorted(ref.TRUNKS)
N1024 = {"sample_num": 1024, "img_size": 192,
         "sa_npoints": (512, 256, 128, 64), "num_category": 6,
         "freeze_world_enhancer": False, "backbone": "resnet18"}
#: sha256 of ResNet-18's weight plan (name, shape, rule, scale, in order)
#: as it was before the other trunks came in; 574 leaves
R18_PLAN = "d7d0e0cc75d1f304a41088b8a4b2f4ce661fe5a0cc880262417ce200ae265f36"


def _digest(plan) -> str:
    rows = [(n, list(shape), rule, repr(scale)) for n, shape, rule, scale
            in plan]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def _encoder(backbone: str, seed: int = 7) -> ref.Encoder:
    """The reference encoder of ``backbone`` with the benchmark's weights
    (made under the names the whole model gives it)."""
    holder = nn.Module()
    holder.rgb_cam_extractor = ref.Encoder(backbone)
    holder.load_state_dict(weights.make_state_dict(holder, seed,
                                                   torch.device("cpu")))
    return holder.rgb_cam_extractor.eval()


def _set_precision(module: nn.Module, kind: str) -> None:
    for m in module.modules():
        if isinstance(m, ref.Net):
            m.p = ref.Precision(kind)


def _rgb(b: int, img: int) -> torch.Tensor:
    return torch.rand(b, img, img, 3, generator=torch.Generator()
                      .manual_seed(3))


def test_resnet18_weight_plan_is_unchanged():
    model = weights.build_on(ref.ISTNet, torch.device("meta"), 6,
                             (512, 256, 128, 64), False)
    plan = weights._plan(model)
    assert len(plan) == 574
    assert _digest(plan) == R18_PLAN
    assert weights._branch_ends(model) == set()


def test_resnet18_flop_counts_are_unchanged():
    assert flops.forward(N1024) == 37713811456.0
    assert flops.train_sample(N1024) == 126146107392.0
    assert flops.encoder(192) == 33494007808.0
    assert flops.encoder(192, "resnet18") == 33494007808.0


def test_only_bottleneck_branch_ends_are_scaled():
    enc = ref.Encoder("resnet50")
    ends = weights._branch_ends(enc)
    assert len(ends) == 2 * sum(ref.TRUNKS["resnet50"][1])
    assert all(".bn3." in name for name in ends)
    assert weights._branch_ends(ref.Encoder("resnet34")) == set()


@pytest.mark.parametrize("backbone", TRUNKS)
def test_each_trunk_matches_the_port_at_float32(backbone):
    """The reference encoder and the port's ``ModifiedResnet`` of the same
    trunk on one state dict, at float32, 48 x 48, B=2 (the port's pyramid
    pooling takes maps whose side 6 divides)."""
    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet
    enc = _encoder(backbone)
    precision.set_compute_dtype(torch.float32)
    port = ModifiedResnet(backbone)
    port.load_state_dict(enc.state_dict())
    x = _rgb(2, 48)
    with torch.no_grad():
        a, b = port.eval()(x), enc(x)
    assert a.shape == b.shape == (2, 48, 48, 128)
    assert torch.allclose(a, b, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("backbone", TRUNKS)
def test_flops_count_every_product_of_the_encoder(backbone):
    """``flops.encoder`` against PyTorch's count of the reference
    encoder's dense forward, at 64 x 64, B=2."""
    with torch.device("meta"):
        enc = ref.Encoder(backbone).eval()
        x = torch.empty(2, 64, 64, 3)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        enc(x)
    assert 2 * flops.encoder(64, backbone) == counter.get_total_flops()


def test_resnet101_seed_weights_are_conditioned_as_resnet18s():
    """At 96 x 96, B=2: the ResNet-101 trunk's float32 and bf16 drift from
    its float64 forward at most twice ResNet-18's, its output's RMS within
    0.3x-3x of ResNet-18's, and one middle block's branch skipped moves
    the encoder's output by at least 5x its bf16 drift."""
    x = _rgb(2, 96)
    seen = {}
    with torch.no_grad():
        for backbone in ("resnet18", "resnet101"):
            enc = _encoder(backbone)
            outs = {}
            for name, module in (("trunk", enc.model.feats), ("encoder", enc)):
                want = copy.deepcopy(module).double()(x.double())
                f32 = module(x).double()
                _set_precision(module, "bf16")
                bf16 = module(x).double()
                _set_precision(module, "float32")
                rms = want.square().mean().sqrt()
                outs[name] = {"want": want, "rms": float(rms),
                              "f32": float((f32 - want).abs().max() / rms),
                              "bf16": float((bf16 - want).square().mean()
                                            .sqrt() / rms)}
            seen[backbone] = outs
        r18, r101 = seen["resnet18"]["trunk"], seen["resnet101"]["trunk"]
        assert r101["f32"] <= 2 * r18["f32"]
        assert r101["bf16"] <= 2 * r18["bf16"]
        assert 0.3 <= r101["rms"] / r18["rms"] <= 3.0

        layer3 = enc.model.feats.layer3
        middle = layer3[len(layer3) // 2]
        middle.forward = lambda t: t      # its branch skipped: x + 0, ReLU
        skipped = enc(x).double()
        out = seen["resnet101"]["encoder"]
        moved = float((skipped - out["want"]).square().mean().sqrt()
                      / out["rms"])
        assert moved >= 5 * out["bf16"]


class _Program(nn.Module):
    """A stand-in of the port's ``ISTNet`` that keeps its arguments."""

    seen: list = []

    def __init__(self, **kwargs):
        super().__init__()
        _Program.seen.append(kwargs)

    def load_state_dict(self, state_dict, strict=True, assign=False):
        return None


@pytest.mark.parametrize("backbone,extra", [
    ("resnet18", {}), ("resnet101", {"backbone": "resnet101"})])
def test_the_program_gets_the_trunk_only_where_it_is_not_resnet18(
        monkeypatch, backbone, extra):
    """A ResNet-18 configuration builds the port's ``ISTNet`` with exactly
    the arguments it took before configurations named a trunk."""
    from istnet_tpu_torch.models import ist_net
    from istnet_tpu_torch.nn import precision
    monkeypatch.setattr(ist_net, "ISTNet", _Program)
    monkeypatch.setattr(weights, "make_state_dict", lambda *a: {})
    monkeypatch.setattr(_Program, "seen", [])
    cfg = {**manifest.config(manifest.load(), "istnet_r18_n1024"),
           "backbone": backbone}
    try:
        models.program(cfg, 1, torch.device("cpu"), False, "float32")
    finally:
        precision.set_compute_dtype(torch.float32)
    assert _Program.seen == [{"nclass": 6, "sa_npoints": (512, 256, 128, 64),
                              "freeze_world_enhancer": False, **extra}]


def test_a_resnet101_configuration_gets_its_flop_counts():
    cfg = {**N1024, "backbone": "resnet101"}
    assert flops.trunk(192, "resnet101") == (49850744832.0, 2048)
    extra = flops.encoder(192, "resnet101") - flops.encoder(192)
    assert flops.forward(cfg) == flops.forward(N1024) + extra
    assert flops.train_sample(cfg) == flops.train_sample(N1024) + 3 * extra
