"""The port's self-training feeds its step the JAX package's batch stream.

``train_synthetic_checkpoint`` of both packages is driven with its train
step replaced by a recorder (no training step runs): the first 20 batches
each one hands its step are held to each other bitwise in points, labels
and offset targets, with the JAX loader's ``min_bucket`` padding stripped
(treelearn_tpu/train/selftrain.py:139-145 builds the dataset and loader
with their default seed 0)."""

import os
import os.path as osp

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N_BATCHES = 20
MODEL = dict(channels=4, num_blocks=2)
RECIPE = dict(steps=N_BATCHES, n_crops=4, crop_extent=12.0, hard_frac=0.5,
              ppt=(1500, 2500), lr=1.5e-3)
KEYS = ("coords", "input_feats", "instance_labels", "semantic_labels",
        "offset_labels", "masks_inner", "masks_off", "masks_sem")


def _strip(batch):
    valid = np.asarray(batch["valid"])
    assert valid[:valid.sum()].all()          # the points come first
    return {k: np.asarray(batch[k])[valid] for k in KEYS + ("batch_ids",)}


def _jax_stream(tmp_path, monkeypatch):
    from treelearn_tpu.train import loop, selftrain

    seen = []

    def make_train_step(model, optimizer, **kw):
        def step(params, state, opt_state, batch):
            seen.append(_strip(batch))
            return params, state, opt_state, 0.0, {}
        return step

    monkeypatch.setattr(loop, "make_train_step", make_train_step)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    selftrain.train_synthetic_checkpoint(
        dict(MODEL), cache_dir=str(tmp_path / "jax"),
        voxel_capacity=1 << 15, **RECIPE)
    return seen


def _port_stream(tmp_path, monkeypatch):
    from treelearn_tpu_torch.train import loop, selftrain

    seen = []

    def make_train_step(model, optimizer, scheduler, **kw):
        def step(batch):
            seen.append(_strip(batch))
            return torch.zeros(()), {}
        return step

    monkeypatch.setattr(loop, "make_train_step", make_train_step)
    path = selftrain.train_synthetic_checkpoint(
        dict(MODEL), cache_dir=str(tmp_path / "port"), device="cpu",
        compute_dtype=torch.float32, **RECIPE)
    return seen, path


def test_first_batches_equal_the_jax_stream(tmp_path, monkeypatch):
    want = _jax_stream(tmp_path, monkeypatch)
    got, _ = _port_stream(tmp_path, monkeypatch)
    assert len(want) == len(got) == N_BATCHES
    for i, (a, b) in enumerate(zip(got, want)):
        for k in KEYS + ("batch_ids",):
            # integers cross into JAX as int32 (x64 off); floats and masks
            # keep their dtype
            if a[k].dtype.kind != "i":
                assert a[k].dtype == b[k].dtype, (i, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"batch {i} {k}")
    # the stream moves: batches differ from each other (augmented, shuffled)
    assert not np.array_equal(got[0]["coords"][:100], got[1]["coords"][:100])


def test_the_old_stream_differs(tmp_path):
    """The stream the port trained on before (dataset and loader seeded
    with seed0 = 101) is not the JAX one: the repair is not a no-op."""
    from treelearn_tpu_torch.data import TreeDataset, TreeLoader
    from treelearn_tpu_torch.train import selftrain

    crops = tmp_path / "crops"
    crops.mkdir()
    selftrain.write_synthetic_crops(str(crops), 4, 12.0, 101, 0.5,
                                    (1500, 2500))
    new = selftrain.training_stream(str(crops), 12.0, 1)
    aug = {"jitter": True, "flip": True, "rot": True, "scaled": False,
           "point_jitter": False}
    old = TreeLoader(TreeDataset(str(crops), inner_square_edge_length=12.0,
                                 training=True, data_augmentations=aug,
                                 seed=101), batch_size=1, seed=101)
    a, b = next(iter(new)), next(iter(old))
    assert not (a["n_points"] == b["n_points"]
                and np.array_equal(a["coords"], b["coords"]))


def test_recipe_key_names_the_stream(tmp_path, monkeypatch):
    """The checkpoint's cache key changed with the stream: a checkpoint
    trained on the old stream is never returned as a cached one."""
    from treelearn_tpu_torch.train import selftrain

    _, path = _port_stream(tmp_path, monkeypatch)
    mc = dict(MODEL)
    side = int(np.ceil((RECIPE["crop_extent"] + 4) / 0.1 / 64)) * 64
    mc["spatial_shape"] = [side, side, 256]
    old = {"steps": RECIPE["steps"], "lr": RECIPE["lr"], "batch_size": 1,
           "n_crops": RECIPE["n_crops"], "crop_extent": RECIPE["crop_extent"],
           "seed0": 101, "v": 7, "dtype": str(torch.float32),
           "ppt": RECIPE["ppt"]}          # hard_frac 0.5 is left out
    new = dict(old, stream_seed=selftrain.STREAM_SEED)
    assert osp.basename(path) == f"selftrain_{selftrain._recipe_key(mc, new)}.pth"
    assert selftrain._recipe_key(mc, old) != selftrain._recipe_key(mc, new)
    # an old-stream checkpoint in the cache is not picked up
    with open(osp.join(tmp_path, "port",
                       f"selftrain_{selftrain._recipe_key(mc, old)}.pth"),
              "wb") as f:
        f.write(b"old stream")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        [osp.basename(path),
         f"selftrain_{selftrain._recipe_key(mc, old)}.pth"])
    assert selftrain.train_synthetic_checkpoint(
        dict(MODEL), cache_dir=str(tmp_path / "port"), device="cpu",
        compute_dtype=torch.float32, **RECIPE) == path


@pytest.mark.parametrize("seed", [0, 101])
def test_stream_seed_is_independent_of_seed0(tmp_path, seed):
    """The crops follow seed0 (seed0 + i), the stream does not: two recipes
    with different seed0 shuffle their crops with the same generator."""
    from treelearn_tpu_torch.train import selftrain

    d = tmp_path / "c"
    d.mkdir()
    selftrain.write_synthetic_crops(str(d), 3, 12.0, seed, 0.5, 1500)
    loader = selftrain.training_stream(str(d), 12.0, 1)
    assert loader.rng.bit_generator.state == np.random.default_rng(
        selftrain.STREAM_SEED).bit_generator.state
    assert loader.dataset.rng.bit_generator.state == np.random.default_rng(
        selftrain.STREAM_SEED).bit_generator.state
