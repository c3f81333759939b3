"""The port's ArcFace data path (s2v_torch.train.arcface_data) against the
JAX package's: the RecordIO container byte for byte (both write the same
bytes; each reads the other's pack), DistributedSampler shards, the batches
from the same seed array-equal with and without the prefetch thread, and
two steps of the port's ``make_arcface_trainer`` on them (on the CPU)."""

import threading

import numpy as np
import pytest
import torch

from s2v_torch.train import arcface_data as TD
from s2v_torch.train.arcface import make_arcface_trainer
from s2v_tpu.train import arcface_data as JD
from torch_parity import one_torch_thread

RECORDS = [(0, np.asarray([7.0, 11.0, 13.0], np.float32), b"alpha"),
           (1, 3.0, b"bravo-longer-payload"), (5, 4.0, b"")]  # sparse keys, header
JOIN_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _bytes(prefix):
    return [open(f"{prefix}.{ext}", "rb").read() for ext in ("rec", "idx")]


def test_both_packages_write_the_same_bytes(tmp_path):
    for name, pkg in (("port", TD), ("jax", JD)):
        pkg.write_record_file(str(tmp_path / name), RECORDS)
        pkg.write_synthetic_pack(str(tmp_path / f"{name}_pack"), num_identities=3,
                                 per_identity=2, seed=4)
    assert _bytes(tmp_path / "port") == _bytes(tmp_path / "jax")
    assert _bytes(tmp_path / "port_pack" / "train") == _bytes(tmp_path / "jax_pack" / "train")
    rec = TD.RecordFile(str(tmp_path / "jax"))
    assert rec.keys == [0, 1, 5]
    for key, label, payload in RECORDS:
        flag, got, data = rec.read_idx(key)
        assert flag == (0 if np.ndim(label) == 0 else len(label)) and data == payload
        np.testing.assert_array_equal(got, label)
    rec.close()


@pytest.mark.parametrize("writer,reader", [(JD, TD), (TD, JD)], ids=["jax_pack", "port_pack"])
def test_each_package_reads_the_others_pack(tmp_path, writer, reader):
    root = writer.write_synthetic_pack(str(tmp_path), num_identities=5, per_identity=3)
    got, want = reader.ArcFaceRecordDataset(root), writer.ArcFaceRecordDataset(root)
    assert len(got) == len(want) == 15
    assert got.header0 == want.header0 and got.num_classes == want.num_classes == 5
    for i in range(len(got)):
        (gi, gl), (wi, wl) = got[i], want[i]
        assert gl == wl == i % 5 and gi.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("n,epoch,count,shuffle", [(103, 2, 8, True), (10, 0, 1, True),
                                                   (7, 5, 3, True), (9, 1, 4, False)])
def test_epoch_indices_match_jax(n, epoch, count, shuffle):
    for index in range(count):
        np.testing.assert_array_equal(
            TD.epoch_indices(n, epoch, index, count, seed=3, shuffle=shuffle),
            JD.epoch_indices(n, epoch, index, count, seed=3, shuffle=shuffle))


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    return TD.write_synthetic_pack(str(tmp_path_factory.mktemp("pack")), num_identities=8,
                                   per_identity=4)


def _drain(batches):
    """The batches of an iterator, read on a thread joined with a timeout, so
    that a stuck prefetch thread fails the test instead of hanging it."""
    out, error = [], []

    def run():
        try:
            out.extend(batches)
        except Exception as e:  # re-raised below
            error.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), f"the batches did not end within {JOIN_S:.0f} s"
    if error:
        raise error[0]
    return out


@pytest.mark.parametrize("prefetch", [0, 2])
def test_record_batches_match_jax(pack, prefetch):
    kw = dict(batch_size=8, epoch=1, index=1, count=2, seed=5, prefetch=prefetch)
    got = _drain(TD.record_batches(TD.ArcFaceRecordDataset(pack), **kw))
    want = _drain(JD.record_batches(JD.ArcFaceRecordDataset(pack), **kw))
    assert len(got) == len(want) == 2
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.shape == (8, 112, 112, 3) and gi.dtype == wi.dtype and gl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_prefetch_hands_a_decode_error_to_the_consumer(pack):
    ds = TD.ArcFaceRecordDataset(pack)
    ds.imgidx = ds.imgidx + 1000  # keys the pack does not hold
    with pytest.raises(KeyError):
        _drain(TD.record_batches(ds, batch_size=4, index=0, count=1, prefetch=2))


def test_trainer_takes_two_steps_from_the_files(pack):
    ds = TD.ArcFaceRecordDataset(pack)
    state, step = make_arcface_trainer(ds.num_classes, embedding_size=32, layers=(1, 1, 1, 1),
                                       device="cpu")
    losses = []
    for imgs, labels in _drain(TD.record_batches(ds, batch_size=8, index=0, count=2)):
        state, m = step(state, imgs, labels)
        losses.append(float(m["loss"]))
    assert len(losses) == 2 and np.isfinite(losses).all() and state.step == 2
    assert isinstance(state.clf_weight, torch.Tensor) and state.clf_weight.shape == (8, 32)
