"""The port's pose visualisation (``eval/vis.py``), ``cli/test.py --vis`` and
``utils/io.py::write_obj`` against the JAX package's.

Every drawing function gives JAX's pixels on the same inputs (boxes of
symmetric and other classes, the axes style, the labels, nocs/gt/pred
sets); ``cli/test.py --vis --vis_axes --vis_labels`` on the CPU writes one
PNG a non-empty frame, each pixel-equal to JAX's ``draw_detections`` run
from the same result pickle; ``write_obj`` writes JAX's text.
"""

import glob
import logging
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from istnet_tpu.eval import vis as J
from istnet_tpu_torch.data import synthetic
from istnet_tpu_torch.entry import build_model
from istnet_tpu_torch.eval import vis as T
from istnet_tpu_torch.utils import write_obj

torch.set_num_threads(1)

INTR = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]], np.float64)


def _srts(n, seed):
    """``n`` sRTs in front of the camera: a y-rotation, a tilt, a scale."""
    rng = np.random.RandomState(seed)
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        yaw, tilt = rng.uniform(-1.5, 1.5), rng.uniform(-0.4, 0.4)
        r, _ = cv2.Rodrigues(np.array([[tilt], [yaw], [0.1 * tilt]]))
        out[i, :3, :3] = rng.uniform(0.7, 1.3) * r
        out[i, :3, 3] = [rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15),
                         rng.uniform(0.8, 1.5)]
        out[i, 3, 3] = 1.0
    return out


def _image(seed):
    return (np.random.RandomState(seed).rand(480, 640, 3) * 255).astype(
        np.uint8)


def test_align_rotation_and_projection_equal_jax():
    for srt in _srts(6, 0):
        np.testing.assert_array_equal(T.align_rotation(srt),
                                      J.align_rotation(srt))
    pts = np.random.RandomState(1).randn(3, 40) * 0.2 + [[0], [0], [1.2]]
    np.testing.assert_array_equal(T.calculate_2d_projections(pts, INTR),
                                  J.calculate_2d_projections(pts, INTR))


@pytest.mark.parametrize("color", [(0, 0, 255), (0, 255, 0), (200, 90, 10)])
def test_box_and_axes_drawing_equal_jax(color):
    rng = np.random.RandomState(sum(color))
    pts = rng.randint(0, 640, (8, 2)).astype(np.int32)
    axes = rng.randint(0, 480, (4, 2)).astype(np.int32)
    img = _image(2)
    np.testing.assert_array_equal(T.draw_bboxes(img.copy(), pts, color),
                                  J.draw_bboxes(img.copy(), pts, color))
    np.testing.assert_array_equal(
        T.draw_axes_box(img.copy(), pts, axes, color),
        J.draw_axes_box(img.copy(), pts, axes, color))


@pytest.mark.parametrize("bbox,text,box", [
    ((100, 200, 150, 260), "laptop", True),
    ((460, 620, 478, 639), "very long label text", False),
    ((0, 0, 10, 10), "mug", True)])
def test_draw_text_equals_jax(bbox, text, box):
    img = _image(3)
    np.testing.assert_array_equal(T.draw_text(img.copy(), bbox, text, box),
                                  J.draw_text(img.copy(), bbox, text, box))


@pytest.mark.parametrize("axes,labels", [(False, False), (True, True)])
def test_draw_detections_equals_jax(tmp_path, axes, labels):
    srts = _srts(7, 4)
    sizes = np.random.RandomState(5).uniform(0.1, 0.4, (7, 3))
    cls = np.array([1, 2, 3, 4, 5, 6, 9])
    kw = dict(gt_srt=srts[:3], gt_size=sizes[:3], gt_class_ids=cls[:3],
              nocs_srt=srts[3:5], nocs_size=sizes[3:5],
              nocs_class_ids=cls[3:5], draw_nocs=True, draw_axes=axes,
              draw_labels=labels)
    img = _image(6)
    got = T.draw_detections(img.copy(), str(tmp_path / "t"), "real", 3, INTR,
                            srts, sizes, cls, **kw)
    want = J.draw_detections(img.copy(), str(tmp_path / "j"), "real", 3,
                             INTR, srts, sizes, cls, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    png = "real_3_pred.png"
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t" / png)),
                                  cv2.imread(str(tmp_path / "j" / png)))


def test_cli_test_vis_writes_the_pngs(tmp_path):
    """``--vis --vis_axes --vis_labels`` over 3 frames, one of them empty
    (its segmentation found nothing): one PNG a non-empty frame, each
    JAX's drawing of the same result pickle."""
    from istnet_tpu.data.dataset import REAL_INTRINSICS
    from istnet_tpu_torch.cli import test as cli

    root = str(tmp_path / "tree")
    synthetic.build_test_tree(root, n_scenes=3)
    seg = glob.glob(os.path.join(root, "data", "segmentation_results",
                                 "test_trainedwithMask", "*.pkl"))
    with open(sorted(seg)[1], "rb") as f:
        empty = pickle.load(f)
    empty["pred_masks"] = empty["pred_masks"][..., :0]
    for k in ("pred_class_ids", "pred_bboxes", "pred_scores"):
        empty[k] = empty[k][:0]
    with open(sorted(seg)[1], "wb") as f:
        pickle.dump(empty, f)
    ckpt = str(tmp_path / "tiny.pth")
    torch.save(build_model(sa_npoints=(32, 16, 8, 8), seed=3,
                           device="cpu").state_dict(), ckpt)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("num_category: 6\nsa_npoints: [32, 16, 8, 8]\n"
                   "test:\n  img_size: 48\n  sample_num: 128\n")
    log_dir = str(tmp_path / "log")
    try:
        iou, pose = cli.main(["--config", str(cfg), "--data_dir", root,
                              "--torch_checkpoint", ckpt, "--device", "cpu",
                              "--log_dir", log_dir, "--vis", "--vis_axes",
                              "--vis_labels"])
    finally:
        for h in list(logging.getLogger("istnet").handlers):
            logging.getLogger("istnet").removeHandler(h)
            h.close()
    assert np.isfinite(iou).all() and np.isfinite(pose).all()
    save = os.path.join(log_dir, "eval_epoch30")
    pngs = sorted(os.listdir(os.path.join(save, "vis")))
    assert pngs == ["real_0_pred.png", "real_2_pred.png"]
    fx, fy, cx, cy = REAL_INTRINSICS
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    for i, png in ((0, pngs[0]), (2, pngs[1])):
        with open(sorted(glob.glob(os.path.join(save, "*.pkl")))[i],
                  "rb") as f:
            r = pickle.load(f)
        img = cv2.imread(os.path.join(root, "data", "Real", "test",
                                      "scene_1", f"{i:04d}_color.png"))
        want = J.draw_detections(
            img, str(tmp_path / "jax_vis"), "real", i, k, r["pred_RTs"],
            r["pred_scales"], r["pred_class_ids"], r["gt_RTs"],
            r["gt_scales"], r["gt_class_ids"], draw_axes=True,
            draw_labels=True)
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(save, "vis", png)), want)


def test_write_obj_equals_jax(tmp_path):
    from istnet_tpu.utils.io import write_obj as jax_write_obj

    pts = np.random.RandomState(7).randn(50, 3).astype(np.float32)
    write_obj(pts, str(tmp_path / "port.obj"))
    jax_write_obj(pts, str(tmp_path / "jax.obj"))
    text = (tmp_path / "port.obj").read_text()
    assert text == (tmp_path / "jax.obj").read_text()
    assert len(text.splitlines()) == 50
