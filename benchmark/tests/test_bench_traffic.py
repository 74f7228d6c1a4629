"""The traffic generator: seeded, reproducible, and the same amount of
work for every seed."""

import numpy as np
import pytest
import torch

from benchmark.harness import manifest, traffic as gen

SMALL = {**manifest.traffic("frame_stream"), "pool": 8}


def _frames_equal(a, b):
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b)
               for k in ("rgb_full", "depth_raw", "masks", "bboxes",
                         "category_label"))


def test_frame_pool_is_reproducible():
    a, b = gen.frame_pool(SMALL, 2**31 + 11), gen.frame_pool(SMALL, 2**31 + 11)
    assert _frames_equal(a, b)
    assert not _frames_equal(a, gen.frame_pool(SMALL, 5))


def test_every_seed_gets_the_same_work():
    pools = [gen.frame_pool(SMALL, s) for s in (1, 2, 3**20)]
    ks = [sorted(f["k"] for f in p) for p in pools]
    tiny = [sum(int((f["masks"][:f["k"]].sum((1, 2)) == 9).sum()) for f in p)
            for p in pools]
    buckets = [sorted(len(f["masks"]) for f in p) for p in pools]
    assert ks[0] == ks[1] == ks[2]
    assert buckets[0] == buckets[1] == buckets[2]
    assert tiny[0] == tiny[1] == tiny[2] == round(0.1 * sum(ks[0]))


def test_frames_are_padded_to_their_bucket():
    for f in gen.frame_pool(SMALL, 4):
        assert len(f["masks"]) == gen.bucket(f["k"], SMALL["max_bucket"])
        assert not f["masks"][f["k"]:].any()
        assert SMALL["k_min"] <= f["k"] <= SMALL["k_max"]


def test_hole_shares_span_the_range():
    rng = np.random.default_rng(0)
    h = gen.stratified(0.2, 0.55, 64, rng)
    assert h.min() == pytest.approx(0.2) and h.max() == pytest.approx(0.55)


@pytest.mark.parametrize("make", [gen.crop_batch, gen.train_batch])
def test_batches_are_reproducible(make):
    def one(seed):
        g = torch.Generator().manual_seed(seed)
        return make(3, 64, 16, 6, g, "cpu")

    def flat(d):
        return [t for v in d.values()
                for t in (flat(v) if isinstance(v, dict) else [v])]
    a, b, c = one(7), one(7), one(8)
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(flat(a)[0], flat(c)[0])


def test_box_clouds_are_consistent_with_their_labels():
    g = torch.Generator().manual_seed(3)
    box = gen.box_clouds(4, 500, g, "cpu")
    r, t, s = (box[k] for k in ("rotation_label", "translation_label",
                                "size_label"))
    eye = torch.eye(3).expand(4, 3, 3)
    assert torch.allclose(r.transpose(1, 2) @ r, eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(r), torch.ones(4), atol=1e-5)
    local = (box["pts"] - t[:, None]) @ r
    assert (local.abs() <= s[:, None] / 2 + 0.006).all()
    # qo = R^T (p - t) / |s|
    assert torch.allclose(box["qo"], local / torch.linalg.norm(
        s, dim=-1)[:, None, None], atol=1e-5)
