#!/usr/bin/env python3
"""The eval BN pass (``ops/bn_eval.py``) on the card, at the call sites of
a full-width eval forward:

    python3 tools/bn_eval_torch.py [--batch 128] [--dtype bfloat16]

Needs one CUDA card and nvcc. The first line is the card's name and power
limit. For the forward of ``--batch`` crops under ``--dtype``
(``chip_smoke.bn_eval_cases``: the maps, statistics, residuals and slopes
the forward hands the pass), each call site through the kernel and its
plain version, equal in every bit (``chip_smoke._check``); then, summed
over the forward: the kernel's device ms (torch.profiler, one launch a
site) and ms by CUDA events over back-to-back launches, the plain
version's ms by events (the same PyTorch ops as the BN's own chain but the
invstd computed once), ``F.batch_norm`` of the same maps (the BN alone, a
yardstick) and the bound (bytes: x and the residual read, y written, at
3.35 TB/s). Then the host's us a call, the card's queue kept ahead: the
pass (``BatchNorm.norm_act``) against the BN's own chain and its consumer
(``BatchNorm.forward`` + ReLU / add + ReLU / PReLU, what an eval BN ran
before the pass) at four sites of a frame_stream-sized forward (B=8). Last,
the whole forward by CUDA events with the pass and with its plain version
in its place.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _host_us(fn, calls: int = 200, rounds: int = 5) -> float:
    """Median over rounds of the host's us a call of ``fn`` over ``calls``
    calls without a synchronise inside (the card's queue absorbs them)."""
    import torch
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def host_costs(device, dtype) -> dict:
    """The host's us a call at four kinds of site of a B=8 forward: the
    trunk's BN + ReLU, a block's last BN + residual add + ReLU, up_3's BN +
    PReLU in the sparse head and a SharedMLP layer's BN + ReLU."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from istnet_tpu_torch.entry import build_model, make_inputs
    from istnet_tpu_torch.nn.layers import prelu
    model = build_model(device, seed=21)
    inputs = make_inputs(8, 1024, seed=22, device=device)
    enc = model.rgb_cam_extractor.model
    block = enc.feats.layer1[0]
    sites = {}

    def grab(name, bn, act):
        def hook(mod, args):
            if name not in sites:
                x = args[0]
                r = torch.randn_like(x) if name == "residual + relu" else None
                sites[name] = (bn, x, act, r)
        return hook

    picks = (("relu", block.bn1, "relu"),
             ("residual + relu", block.bn2, "relu"),
             ("prelu", enc.up_3.conv[2], "prelu"),
             ("mlp relu", model.pts_cam_extractor.FP_modules[0].mlp[0]
              .normlayer.bn, "relu"))
    # every pick's input: one forward with its chain in place of the pass
    handles = [bn.register_forward_pre_hook(grab(name, bn, act))
               for name, bn, act in picks]
    for _, bn, _ in picks:
        bn.norm_act = lambda x, act=None, residual=None, slope=None, bn=bn: \
            _chain(bn, x, act, residual, slope)
    try:
        with cs.policy(dtype), torch.inference_mode():
            model(inputs)
    finally:
        for h in handles:
            h.remove()
        for _, bn, _ in picks:
            del bn.norm_act
    slope = enc.up_3.conv[3].weight
    out = {}
    with cs.policy(dtype), torch.inference_mode():
        for name, (bn, x, act, r) in sites.items():
            s = slope if act == "prelu" else None

            def chain():
                y = bn(x)
                if act == "prelu":
                    return prelu(y, s)
                return F.relu(y if r is None else y + r)

            def fused():
                return bn.norm_act(x, act, r, s)

            fused()
            chain()
            out[name] = {"shape": list(x.shape),
                         "pass_us": _host_us(fused),
                         "chain_us": _host_us(chain)}
    return out


def _chain(bn, x, act, residual, slope):
    import torch.nn.functional as F

    from istnet_tpu_torch.nn.layers import prelu
    y = bn(x)
    if act == "relu":
        return F.relu(y if residual is None else y + residual)
    return prelu(y, slope) if act == "prelu" else y


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    from istnet_tpu_torch.entry import build_model, make_inputs
    from istnet_tpu_torch.ops import bn_eval, dispatch
    from istnet_tpu_torch.utils.profiling import cuda_ms, device_us
    if not torch.cuda.is_available():
        raise SystemExit("bn_eval_torch: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cs.phase_build()
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    kern = dispatch.wrapper("bn_eval")
    sites = cs.bn_eval_cases(dev, dtype, args.batch)
    rows = []
    total = {"device_ms": 0.0, "events_ms": 0.0, "plain_ms": 0.0,
             "batch_norm_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
             "device_sites": 0}
    for site in sites:
        cs._check("bn_eval", kern(*site), bn_eval.plain(*site), False)
        dev_us = sum(device_us(lambda: kern(*site)).values()) or float("nan")
        if dev_us == dev_us:
            total["device_sites"] += 1
        ev = cuda_ms(lambda: kern(*site), iters=20)
        pl = cuda_ms(lambda: bn_eval.plain(*site), iters=5)
        bn = cuda_ms(cs.library_call("bn_eval", site), iters=20)
        by, _ = cs.bound_ms("bn_eval", site, kern(*site))
        nbytes = by * 1e-3 * cs.HBM_BPS
        rows.append((cs._label("bn_eval", site), dev_us, by))
        for k, v in (("device_ms", 0.0 if dev_us != dev_us else dev_us * 1e-3),
                     ("events_ms", ev),
                     ("plain_ms", pl), ("batch_norm_ms", bn),
                     ("bound_ms", by), ("bytes", nbytes)):
            total[k] += v
        print(f"[bn_eval] {rows[-1][0]}: device {dev_us:.1f} us, events "
              f"{ev * 1e3:.1f} us, plain {pl * 1e3:.1f} us, F.batch_norm "
              f"{bn * 1e3:.1f} us, bound {by * 1e3:.1f} us "
              f"({by * 1e3 / dev_us:.0%} of it)")
    total["sites"] = len(sites)
    print(f"[bn_eval] B={args.batch} {args.dtype}: {len(sites)} sites, all "
          f"bit-equal to the plain version; a forward: device "
          f"{total['device_ms']:.3f} ms (the {total['device_sites']} sites "
          f"whose events the profiler kept), events "
          f"{total['events_ms']:.3f}, "
          f"plain {total['plain_ms']:.3f}, F.batch_norm "
          f"{total['batch_norm_ms']:.3f}, bound {total['bound_ms']:.3f} ms "
          f"({total['bytes'] / 1e9:.3f} GB)")
    del sites
    host = host_costs(dev, dtype)
    for name, h in host.items():
        print(f"[bn_eval] host us a call, B=8 {args.dtype} {name} "
              f"{tuple(h['shape'])}: pass {h['pass_us']:.1f}, the BN's chain "
              f"and consumer {h['chain_us']:.1f}")
    model = build_model(dev, seed=23)
    inputs = make_inputs(args.batch, 1024, seed=24, device=dev)
    fwd = {}
    with cs.policy(dtype), torch.inference_mode():
        for label in ("pass", "plain", "plain", "pass"):
            if label == "plain":
                dispatch.bn_eval, real = bn_eval.plain, dispatch.bn_eval
            try:
                fwd.setdefault(label, []).append(
                    cuda_ms(lambda: model(inputs), iters=10))
            finally:
                if label == "plain":
                    dispatch.bn_eval = real
    print(f"[bn_eval] B={args.batch} {args.dtype} forward by events "
          f"(pass, plain, plain, pass): "
          + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f} ms"
                      for k, v in fwd.items()))
    result = {"batch": args.batch, "dtype": args.dtype, "forward": total,
              "host_us": host, "forward_ms": fwd,
              "card": torch.cuda.get_device_name(dev)}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
