"""The program's model and the reference's, both loaded with the
benchmark's weights (``weights.make_state_dict``) on the run's device.

The program is ``istnet_tpu_torch``'s ``ISTNet`` under its compute
policy; the reference is ``benchmark.reference.model.ISTNet`` at a
``Precision`` of its own. Both are built without an init and then
loaded, so set-up makes the weights once, on the device.
"""

from __future__ import annotations

import torch

from benchmark.harness import weights
from benchmark.reference import model as ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def reference(cfg: dict, seed: int, device, train: bool,
              precision: str = "float32") -> ref.ISTNet:
    m = weights.build_on(ref.ISTNet, device, cfg["num_category"],
                         tuple(cfg["sa_npoints"]),
                         bool(cfg["freeze_world_enhancer"]),
                         backbone=cfg["backbone"])
    m.load_state_dict(weights.make_state_dict(m, seed, device))
    m.set_precision(ref.Precision(precision))
    return m.train(train)


def program(cfg: dict, seed: int, device, train: bool, dtype: str):
    """The port's ``ISTNet`` with the benchmark's weights, the port's
    compute policy set to ``dtype`` (a global of the port). A trunk other
    than ResNet-18 is handed over as ``backbone=``, which a port whose
    ``ISTNet`` builds ResNet-18 alone refuses with a ``TypeError``."""
    from istnet_tpu_torch.models.ist_net import ISTNet
    from istnet_tpu_torch.nn import precision

    precision.set_compute_dtype(DTYPES[dtype])
    backbone = cfg["backbone"]
    shape = weights.build_on(ref.ISTNet, torch.device("meta"),
                             cfg["num_category"], tuple(cfg["sa_npoints"]),
                             backbone=backbone)
    trunk = {} if backbone == "resnet18" else {"backbone": backbone}
    m = weights.build_on(ISTNet, device, nclass=cfg["num_category"],
                         sa_npoints=tuple(cfg["sa_npoints"]),
                         freeze_world_enhancer=bool(
                             cfg["freeze_world_enhancer"]), **trunk)
    m.load_state_dict(weights.make_state_dict(shape, seed, device))
    return m.train(train)
