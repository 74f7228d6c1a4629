"""Test-time inference loops: per-image instance batches -> result pkls.

Counterpart of ``istnet_tpu/eval/test_loop.py``. Four loops write the same
result pkls for ``eval.nocs_map.evaluate``:

- ``test_func`` / ``test_func_batched``: the dataset preprocesses on the
  host; ``forward(inputs) -> end_points`` takes numpy arrays.
- ``test_func_device`` / ``test_func_device_batched``: the dataset yields
  raw frames (``TestDataset(device_preprocess=True)``) and depth completion
  (kernel 11 on the card), crop, sampling, back-projection and resize run on
  the model's device, in front of the eval forward.

Images have variable instance counts, so the per-image loops pad to bucket
sizes (powers of two up to ``max_bucket``) and drop the padded rows before
saving; PyTorch needs no static shapes, but the buckets keep the shapes a
kernel sees few and the pkls equal to the JAX package's. Pose assembly:
``scale = ||size||``, ``RT[:3,:3] = R * scale``, ``RT[:3,3] = t``,
``scales = size / scale``.

Results leave the device late: each loop queues a closure that copies its
tensors to the host and writes, and ``_DrainQueue`` runs the oldest only
when more than ``depth`` are waiting, so the host's decoding, the device's
work and the writing overlap.

Data parallel (JAX's ``mesh=``): ``make_forward(model, devices)`` and
``test_func_device_batched(..., devices=...)`` run each instance batch
through ``parallel.mesh.eval_forward_dp``, a replica of the model on each
device, its rows split over them; the batch must divide by their count.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from istnet_tpu_torch.data.device_preprocess import (
    fill_missing, preprocess_shared_image)
from istnet_tpu_torch.parallel.mesh import eval_forward_dp
from istnet_tpu_torch.utils import tracing

_POSE_KEYS = ("pred_rotation", "pred_translation", "pred_size")
_GT_KEYS = ("gt_class_ids", "gt_bboxes", "gt_RTs", "gt_scales",
            "gt_handle_visibility")
_DET_KEYS = ("pred_class_ids", "pred_bboxes", "pred_scores")


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _bucket(n: int, max_bucket: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_bucket)


def pad_instances(inputs: dict, bucket: int) -> dict:
    """Pad the instance axis to ``bucket`` by repeating row 0."""
    out = {}
    n = inputs["pts"].shape[0]
    for k, v in inputs.items():
        if n < bucket:
            pad = np.repeat(v[:1], bucket - n, axis=0)
            v = np.concatenate([v, pad], axis=0)
        out[k] = v
    return out


def assemble_pose(pred_rotation: np.ndarray, pred_translation: np.ndarray,
                  pred_size: np.ndarray):
    """(R, t, size) -> (pred_RTs (N,4,4), pred_scales (N,3))."""
    scale = np.linalg.norm(pred_size, axis=1, keepdims=True)
    pred_scales = pred_size / scale
    n = pred_rotation.shape[0]
    rts = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rts[:, :3, :3] = pred_rotation * scale[:, :, None]
    rts[:, :3, 3] = pred_translation
    return rts, pred_scales


def _set_poses(result: dict, r, t, s) -> None:
    if len(r):
        result["pred_RTs"], result["pred_scales"] = assemble_pose(
            np.asarray(r), np.asarray(t), np.asarray(s))
    else:
        result["pred_RTs"] = np.zeros((0, 4, 4), np.float32)
        result["pred_scales"] = np.zeros((0, 3), np.float32)


def _gt_result(gt: dict) -> dict:
    return {k: np.asarray(gt[k]) for k in _GT_KEYS}


def _set_detections(result: dict, gt: dict, keep) -> None:
    for k in _DET_KEYS:
        result[k] = np.asarray(gt[k])[keep]


def _dump(result: dict, save_path: str, pkl_path: str) -> None:
    with open(os.path.join(save_path, os.path.basename(pkl_path)), "wb") as f:
        pickle.dump(result, f)


class _DrainQueue:
    """Deferred device-to-host drain for the inference loops.

    Reading a result right after its forward makes the host wait for the
    device once per image and serialises decoding and pickling against
    inference. Each loop queues a closure that copies and writes, and the
    queue runs the OLDEST one only when more than ``depth`` are waiting."""

    def __init__(self, depth: int = 2):
        self.depth = depth
        self._q: list = []

    def push(self, finish) -> None:
        self._q.append(finish)
        while len(self._q) > self.depth:
            self._q.pop(0)()

    def flush(self) -> None:
        while self._q:
            self._q.pop(0)()


def _prefetch(dataset, n_workers: int = 2, depth: int = 4):
    """Yield dataset[i] in order with background-thread preprocessing (the
    per-image decode otherwise serialises with device inference)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    n = len(dataset)
    with ThreadPoolExecutor(n_workers) as pool:
        window: deque = deque()
        nxt = 0
        while nxt < min(depth, n):
            window.append(pool.submit(dataset.__getitem__, nxt))
            nxt += 1
        while window:
            item = window.popleft().result()
            if nxt < n:  # sliding window bounds in-flight results
                window.append(pool.submit(dataset.__getitem__, nxt))
                nxt += 1
            yield item


def _iterate(dataset, n_workers: int, progress: bool):
    it = _prefetch(dataset, n_workers=n_workers)
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(it, total=len(dataset))
        except ImportError:
            pass
    return it


def _pad_chunk(masks, bboxes, category, size: int):
    """Pad a chunk of instances to ``size`` rows with empty masks (so
    ``n_valid`` is 0 and the rows are dropped), the last box and class 0."""
    pad = size - masks.shape[0]
    if pad <= 0:
        return masks, bboxes, category
    return (np.concatenate([masks, np.zeros((pad,) + masks.shape[1:],
                                            masks.dtype)]),
            np.concatenate([bboxes, np.tile(bboxes[-1:], (pad, 1))]),
            np.concatenate([category, np.zeros(pad, category.dtype)]))


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def make_forward(model, devices=None):
    """``forward(inputs) -> end_points`` for ``test_func`` and
    ``test_func_batched``: numpy (or tensor) inputs go to the model's
    device and through its eval forward; with ``devices``, through a
    replica on each of them (``eval_forward_dp``), outputs on the first."""
    if devices is not None:
        return eval_forward_dp(model, devices)
    device = _model_device(model)

    @torch.inference_mode()
    def forward(inputs: dict) -> dict:
        return model({k: torch.as_tensor(v).to(device)
                      for k, v in inputs.items()})

    return forward


def make_device_forward(model, intrinsics, img_size: int = 192,
                        sample_num: int = 1024):
    """Build fn: raw image + instance masks -> end_points, with all
    preprocessing (depth completion, crop, sampling, back-projection,
    resize) on the model's device in front of the eval forward.

    Returns fn(rgb_full u8 (H,W,3), depth_raw (H,W), masks (K,H,W) bool,
    bboxes (K,4), category (K,), generator=None, v=None) -> (end_points,
    n_valid (K,)). The sampler's uniforms come from ``generator`` (a
    ``torch.Generator`` on the model's device, ``fn.device``) or are
    ``v (K, sample_num)``.

    Under a profiler a call is the span ``serve`` (its item the call's
    number) around ``h2d``, ``fill``, ``preprocess`` and the model's
    ``forward``; the counters ``serve.frames`` and ``h2d.bytes`` (the
    frame's bytes in host memory) are always on (``utils/tracing.py``).
    """
    device = _model_device(model)
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def fn(rgb_full, depth_raw, masks, bboxes, category, generator=None,
           v=None):
        frame = tracing.count("serve.frames") - 1
        with tracing.span("serve", item=frame):
            with tracing.span("h2d"):
                arrays = (rgb_full, depth_raw, masks, bboxes, category)
                tracing.count("h2d.bytes", tracing.host_bytes(arrays))
                rgb_full, depth_raw, masks, bboxes, category = (
                    torch.as_tensor(a).to(device) for a in arrays)
            with tracing.span("fill"):
                filled = fill_missing(depth_raw[None].float())[0]
            with tracing.span("preprocess"):
                pre = preprocess_shared_image(
                    rgb_full, filled, masks, bboxes, intr, generator,
                    img_size=img_size, sample_num=sample_num, v=v)
            inputs = {"rgb": pre["rgb"], "pts": pre["pts"],
                      "choose": pre["choose"],
                      "category_label": category.to(torch.int32)}
            return model(inputs), pre["n_valid"]

    fn.device = device
    return fn


def _device_generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def test_func_device(device_forward, dataset, save_path: str,
                     max_bucket: int = 64, progress: bool = True,
                     min_points: int = 16, seed: int = 0) -> None:
    """Device-pipeline variant of ``test_func``: the dataset yields raw
    arrays (``TestDataset(device_preprocess=True)``); instances with <=
    ``min_points`` valid pixels are dropped AFTER the device pass."""
    os.makedirs(save_path, exist_ok=True)
    dq = _DrainQueue()
    generator = _device_generator(device_forward.device, seed)
    for i, data in enumerate(_iterate(dataset, 2, progress)):
        gt = data["gt"]
        result = _gt_result(gt)
        path = dataset.result_pkl_list[i]
        k = data["masks"].shape[0] if "masks" in data else 0
        if data.get("empty", False) or k == 0:
            _set_detections(result, gt, np.zeros(len(gt["pred_class_ids"]),
                                                 bool))
            _set_poses(result, [], [], [])
            _dump(result, save_path, path)
            continue

        masks, bboxes, category = _pad_chunk(
            data["masks"], data["bboxes"], data["category_label"],
            _bucket(k, max_bucket))
        end_points, n_valid = device_forward(
            data["rgb_full"], data["depth_raw"], masks, bboxes, category,
            generator)
        ep = [end_points[name] for name in _POSE_KEYS]

        def finish(result=result, gt=gt, ep=ep, n_valid=n_valid, k=k,
                   path=path):
            keep = _numpy(n_valid)[:k] > min_points
            _set_detections(result, gt, keep)
            _set_poses(result, *(_numpy(e)[:k][keep] for e in ep))
            _dump(result, save_path, path)

        dq.push(finish)
    dq.flush()


def make_device_batched(model, intrinsics, img_size: int = 192,
                        sample_num: int = 1024, batch_size: int = 64,
                        kb: int = 16, lag: int = 2, min_points: int = 16,
                        devices=None):
    """Device-side streaming compaction: the device preprocessing composed
    with cross-image instance batching; preprocessed instances never leave
    the device between the two.

    - ``fill(depth_raw)``: the frame's completed depth (kernel 11 on the
      card), once per frame and shared by the frame's chunks.
    - ``append(buffers, pos, rgb_full, filled, masks, bboxes, category,
      generator=None, v=None)``: crop/sample/back-project for ``kb``
      instance masks, then a compacting scatter of the instances with >
      ``min_points`` valid pixels into ``buffers`` at the device cursor
      ``pos`` (a 0-d tensor: appending never waits for the device);
      invalid rows all land in one trash slot. Returns ``n_valid``.
    - ``forward(buffers, pos)``: the eval forward on ``buffers[:B]``; then
      the overflow region ``[B:BUF)`` moves to the front and the cursor
      drops by B.

    With ``devices`` the forward runs over a replica on each device
    (``eval_forward_dp``; the buffers stay on the model's device, the
    first of them): ``batch_size`` must divide by their count.

    Buffers and cursor are updated in place. The buffer holds ``BUF = B +
    (lag+1)*kb + 1`` rows: the host learns each chunk's valid count up to
    ``lag`` chunks late, so up to ``lag+1`` undecided chunks may append
    before a flush; the overflow region absorbs them and the last row is the
    trash slot.

    Returns ``(init_buffers, fill, append, forward)``.
    """
    device = _model_device(model)
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=device)
    buf_n = batch_size + (lag + 1) * kb + 1
    trash = buf_n - 1
    if devices is not None and batch_size % len(devices):
        raise ValueError(f"eval batch {batch_size} must divide by the "
                         f"{len(devices)}-device mesh")
    run = model if devices is None else eval_forward_dp(model, devices)

    def init_buffers():
        bufs = {
            "rgb": torch.zeros(buf_n, img_size, img_size, 3, device=device),
            "pts": torch.zeros(buf_n, sample_num, 3, device=device),
            "choose": torch.zeros(buf_n, sample_num, dtype=torch.int32,
                                  device=device),
            "category_label": torch.zeros(buf_n, dtype=torch.int32,
                                          device=device),
        }
        return bufs, torch.zeros((), dtype=torch.long, device=device)

    @torch.inference_mode()
    def fill(depth_raw):
        depth_raw = torch.as_tensor(depth_raw).to(device)
        return fill_missing(depth_raw[None].float())[0]

    @torch.inference_mode()
    def append(buffers, pos, rgb_full, filled, masks, bboxes, category,
               generator=None, v=None):
        rgb_full, masks, bboxes, category = (
            torch.as_tensor(a).to(device)
            for a in (rgb_full, masks, bboxes, category))
        pre = preprocess_shared_image(
            rgb_full, filled, masks, bboxes, intr, generator,
            img_size=img_size, sample_num=sample_num, v=v)
        valid = pre["n_valid"] > min_points                     # (kb,)
        dst = torch.where(valid, pos + torch.cumsum(valid, 0) - 1, trash)
        chunk = {"rgb": pre["rgb"], "pts": pre["pts"],
                 "choose": pre["choose"], "category_label": category}
        for name, buf in buffers.items():
            buf[dst] = chunk[name].to(buf.dtype)
        pos += valid.sum()
        return pre["n_valid"]

    @torch.inference_mode()
    def forward(buffers, pos):
        ep = run({k: v[:batch_size] for k, v in buffers.items()})
        ep = {k: ep[k] for k in _POSE_KEYS}
        for v in buffers.values():
            # source and destination overlap: move through a copy
            v[: buf_n - batch_size] = v[batch_size:].clone()
        pos -= batch_size
        return ep

    return init_buffers, fill, append, forward


def test_func_device_batched(model, dataset, save_path: str, intrinsics,
                             img_size: int = 192, sample_num: int = 1024,
                             batch_size: int = 64, kb: int = 16,
                             min_points: int = 16, lag: int = 2,
                             progress: bool = True, seed: int = 0,
                             devices=None) -> None:
    """Device preprocessing WITH cross-image instance batching: the dataset
    yields raw arrays (``TestDataset(device_preprocess=True)``); the model
    runs once per ``batch_size`` valid instances across images instead of
    once per image. Same result pkls as the other loops.

    Host bookkeeping: valid instances get consecutive global sequence
    numbers in device scatter order, so instance ``seq`` comes back as row
    ``seq % batch_size`` of flush ``seq // batch_size``. The host never
    needs buffer positions, only each chunk's ``n_valid``, which it reads
    ``lag`` chunks late from pinned memory (a non-blocking copy and an
    event), so that no frame waits for the device. ``devices``: the
    forward over a replica on each (``make_device_batched``).
    """
    os.makedirs(save_path, exist_ok=True)
    device = _model_device(model)
    init_buffers, fill, append, forward = make_device_batched(
        model, intrinsics, img_size=img_size, sample_num=sample_num,
        batch_size=batch_size, kb=kb, lag=lag, min_points=min_points,
        devices=devices)
    buffers, pos = init_buffers()
    generator = _device_generator(device, seed)

    dq = _DrainQueue()
    img_state: dict[int, dict] = {}     # image idx -> assembly state
    chunk_q: list = []                  # undecided (img_idx, chunk_lo, read)
    flush_eps: list = []                # per-flush host copies of the poses
    n_flushed = 0                       # flushes dispatched
    seq = 0                             # next global sequence number

    def _later(tensors: dict):
        """Start the copy of ``tensors`` to the host; the returned function
        waits for it and gives the numpy arrays."""
        if device.type != "cuda":
            return lambda: {k: _numpy(t) for k, t in tensors.items()}
        host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for k, t in tensors.items()}
        for k, t in tensors.items():
            host[k].copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def read():
            done.synchronize()
            return {k: _numpy(t) for k, t in host.items()}

        return read

    def _flush() -> None:
        nonlocal n_flushed
        flush_eps.append(_later(forward(buffers, pos)))
        n_flushed += 1

    def _write(i: int) -> None:
        st = img_state.pop(i)
        rows = []
        for s in st["rows"]:
            f, r = divmod(s, batch_size)
            if callable(flush_eps[f]):
                flush_eps[f] = flush_eps[f]()
            rows.append([flush_eps[f][k][r] for k in _POSE_KEYS])
        _set_poses(st["result"], *([row[j] for row in rows] for j in range(3)))
        _dump(st["result"], save_path, dataset.result_pkl_list[st["index"]])

    def _resolve_chunk() -> None:
        """Read the oldest chunk's n_valid; assign sequence numbers."""
        nonlocal seq
        i, lo, read = chunk_q.pop(0)
        st = img_state[i]
        for j, v in enumerate(read()["n_valid"]):
            orig = lo + j
            if orig >= st["k"]:
                continue                      # mask padding row
            keep = bool(v > min_points)
            st["keep"][orig] = keep
            if keep:
                st["rows"].append(seq)
                seq += 1
        st["chunks_left"] -= 1
        while seq - n_flushed * batch_size >= batch_size:
            _flush()
        if st["chunks_left"] == 0:
            st["ready"] = True
            _maybe_finish()

    def _maybe_finish() -> None:
        """Write images (in order) whose rows all live in dispatched flushes."""
        for i in sorted(img_state):
            st = img_state[i]
            if st.get("queued"):
                continue            # pushed, awaiting its deferred _write
            if not st["ready"]:
                break
            if st["rows"] and st["rows"][-1] >= n_flushed * batch_size:
                break
            st["queued"] = True
            keep = np.asarray([st["keep"][j] for j in range(st["k"])], bool)
            _set_detections(st["result"], st["gt"], keep)
            dq.push(lambda i=i: _write(i))

    for i, data in enumerate(_iterate(dataset, 2, progress)):
        gt = data["gt"]
        k = 0 if data.get("empty", False) else data["masks"].shape[0]
        n_chunks = (k + kb - 1) // kb
        img_state[i] = {"index": i, "result": _gt_result(gt), "gt": gt,
                        "k": k, "rows": [], "keep": {},
                        "chunks_left": n_chunks, "ready": n_chunks == 0}
        if k == 0:
            for kk in _DET_KEYS:
                img_state[i]["result"][kk] = np.asarray(gt[kk])[:0]
            _maybe_finish()
            continue
        filled = fill(data["depth_raw"])
        rgb_full = torch.as_tensor(data["rgb_full"]).to(device)
        for lo in range(0, k, kb):
            masks, bboxes, category = _pad_chunk(
                data["masks"][lo:lo + kb], data["bboxes"][lo:lo + kb],
                data["category_label"][lo:lo + kb], kb)
            n_valid = append(buffers, pos, rgb_full, filled, masks, bboxes,
                             category, generator)
            chunk_q.append((i, lo, _later({"n_valid": n_valid})))
            while len(chunk_q) > lag:
                _resolve_chunk()
    while chunk_q:
        _resolve_chunk()
    if seq > n_flushed * batch_size:        # remainder flush (partial batch)
        _flush()
    _maybe_finish()
    dq.flush()
    assert not img_state, f"unfinished images: {sorted(img_state)}"


def test_func_batched(forward, dataset, save_path: str,
                      batch_size: int = 64, progress: bool = True,
                      prefetch_workers: int = 4) -> None:
    """Cross-image instance batching with host preprocessing: instances
    stream from the prefetched images into a fixed ``batch_size`` buffer,
    the forward runs once per full buffer, and results scatter back to their
    images (written in order as they complete). The remainder batch pads by
    repeating its last instance. Same result pkls as ``test_func``."""
    os.makedirs(save_path, exist_ok=True)
    dq = _DrainQueue()
    pending_inputs: list[dict] = []  # one entry per queued instance
    pending_img: list[int] = []      # owning image index per queued instance
    img_state: dict[int, dict] = {}  # image index -> result assembly state
    keys = ("rgb", "pts", "choose", "category_label")

    def flush(n_take: int) -> None:
        """Run the forward on the first n_take queued instances."""
        take = pending_inputs[:n_take]
        owners = pending_img[:n_take]
        del pending_inputs[:n_take], pending_img[:n_take]
        stacked = {k: np.stack([inst[k] for inst in take]) for k in keys}
        if n_take < batch_size:  # remainder: pad to the one shape
            reps = batch_size - n_take
            for k, v in stacked.items():
                stacked[k] = np.concatenate([v, np.repeat(v[-1:], reps, axis=0)])
        end_points = forward(stacked)
        ep = [end_points[k] for k in _POSE_KEYS]

        def finish(ep=ep, owners=owners, n_take=n_take):
            r, t, s = (_numpy(e)[:n_take] for e in ep)
            for j, owner in enumerate(owners):
                img_state[owner]["preds"].append((r[j], t[j], s[j]))
            for owner in sorted(set(owners)):
                st = img_state[owner]
                if len(st["preds"]) == st["n_expected"]:
                    _write(owner)

        dq.push(finish)

    def _write(owner: int) -> None:
        st = img_state.pop(owner)
        _set_poses(st["result"],
                   *([p[j] for p in st["preds"]] for j in range(3)))
        _dump(st["result"], save_path, dataset.result_pkl_list[st["index"]])

    for i, data in enumerate(_iterate(dataset, prefetch_workers, progress)):
        gt = data["gt"]
        result = _gt_result(gt)
        _set_detections(result, gt, data["flag_instance"])
        n = 0 if data.get("empty", False) else data["pts"].shape[0]
        img_state[i] = {"index": i, "result": result, "preds": [],
                        "n_expected": n}
        if n == 0:
            _write(i)
            continue
        for j in range(n):
            pending_inputs.append({k: data[k][j] for k in keys})
            pending_img.append(i)
        while len(pending_inputs) >= batch_size:
            flush(batch_size)
    if pending_inputs:
        flush(len(pending_inputs))
    dq.flush()
    assert not img_state, f"unfinished images: {sorted(img_state)}"


def test_func(forward, dataset, save_path: str,
              max_bucket: int = 64, progress: bool = True,
              prefetch_workers: int = 2) -> None:
    """Run inference over a ``TestDataset`` and dump per-image result pkls.
    ``forward(inputs) -> end_points`` is an eval forward over an
    instance batch of numpy arrays (``make_forward``)."""
    os.makedirs(save_path, exist_ok=True)
    dq = _DrainQueue()
    for i, data in enumerate(_iterate(dataset, prefetch_workers, progress)):
        gt = data["gt"]
        result = _gt_result(gt)
        _set_detections(result, gt, data["flag_instance"])
        path = dataset.result_pkl_list[i]
        if data.get("empty", False):
            _set_poses(result, [], [], [])
            _dump(result, save_path, path)
            continue

        n = data["pts"].shape[0]
        inputs = pad_instances(
            {k: data[k] for k in ("rgb", "pts", "choose", "category_label")},
            _bucket(n, max_bucket))
        end_points = forward(inputs)
        ep = [end_points[k] for k in _POSE_KEYS]

        def finish(result=result, ep=ep, n=n, path=path):
            _set_poses(result, *(_numpy(e)[:n] for e in ep))
            _dump(result, save_path, path)

        dq.push(finish)
    dq.flush()


# the loops are named after the reference's; they are not pytest tests
for _fn in (test_func, test_func_batched, test_func_device,
            test_func_device_batched):
    _fn.__test__ = False
