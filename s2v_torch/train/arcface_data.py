"""Arcface training-data reader — the MXFaceDataset + DistributedSampler +
DataLoaderX equivalent (reference:
third_part/face3d/models/arcface_torch/dataset.py:70-107 and
train.py:37-45; a copy of s2v_tpu/train/arcface_data.py, whose packs it
reads and writes byte for byte).

The reference trains from mxnet indexed RecordIO packs (``train.rec`` +
``train.idx``) of JPEG faces with identity labels, partitioned across ranks
by ``DistributedSampler`` and prefetched on a background thread
(``DataLoaderX``/``BackgroundGenerator``, dataset.py:13-67). Here, without
mxnet or a DataLoader:

- ``RecordFile`` / ``write_record_file``: the RecordIO container parsed
  (and written) in pure Python — same binary layout as
  ``mx.recordio.MXIndexedRecordIO`` (magic word, cflag|length word, IRHeader
  ``=IfQQ``, flag>0 multi-label, 4-byte record padding), so real arcface
  ``train.rec`` packs load without mxnet.
- ``ArcFaceRecordDataset``: MXFaceDataset semantics — header0 detection
  (record 0 holding [num_records, num_identities]), label extraction,
  JPEG decode via Pillow (imported there and in ``write_synthetic_pack``
  only: the card's machine has none), hflip + (x/255 - 0.5)/0.5
  normalization.
- ``epoch_indices``: DistributedSampler — epoch-seeded shuffle, pad to a
  multiple of world size, rank-strided slice (each host sees a disjoint,
  equally-sized shard; the union covers every record).
- ``record_batches``: per-process batch iterator with background-thread
  prefetch feeding ``train.arcface.make_arcface_trainer`` (images
  [B,112,112,3] float32 numpy in [-1,1], NHWC as the trainer takes them,
  labels int32).
"""

from __future__ import annotations

import io
import os
import struct
import threading
import queue as _queue
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_MAGIC = 0xCED7230A
_IR_FORMAT = "=IfQQ"  # flag, label, id, id2 (mx.recordio.IRHeader)
_IR_SIZE = struct.calcsize(_IR_FORMAT)


# ---------------------------------------------------------------------------
# RecordIO container
# ---------------------------------------------------------------------------


def _pack_record(header_flag: int, label, rec_id: int,
                 payload: bytes) -> bytes:
    """mx.recordio.pack: IRHeader (+ float32 label vector when flag>0)."""
    if np.ndim(label) == 0:
        data = struct.pack(_IR_FORMAT, header_flag, float(label), rec_id, 0)
    else:
        lab = np.asarray(label, np.float32)
        data = struct.pack(_IR_FORMAT, lab.size, 0.0, rec_id, 0) + lab.tobytes()
    return data + payload


def _unpack_record(data: bytes):
    """mx.recordio.unpack: (flag, label, payload). flag>0 means the label is
    a float32 vector stored after the base header."""
    flag, label, _id, _id2 = struct.unpack(_IR_FORMAT, data[:_IR_SIZE])
    if flag > 0:
        lab = np.frombuffer(data[_IR_SIZE:_IR_SIZE + 4 * flag], np.float32)
        return flag, lab, data[_IR_SIZE + 4 * flag:]
    return flag, label, data[_IR_SIZE:]


def write_record_file(prefix: str, records) -> None:
    """Write an indexed RecordIO pack: ``prefix.rec`` + ``prefix.idx``.

    ``records``: iterable of (key, label, payload_bytes); label may be a
    scalar or a float vector (flag>0 form, used by the header0 record)."""
    with open(prefix + ".rec", "wb") as rec, open(prefix + ".idx", "w") as idx:
        pos = 0
        for key, label, payload in records:
            flag = 0 if np.ndim(label) == 0 else len(label)
            data = _pack_record(flag, label, int(key), payload)
            n = len(data)
            rec.write(struct.pack("<I", _MAGIC))
            rec.write(struct.pack("<I", n & ((1 << 29) - 1)))
            rec.write(data)
            pad = (4 - n % 4) % 4
            rec.write(b"\x00" * pad)
            idx.write(f"{int(key)}\t{pos}\n")
            pos += 8 + n + pad


class RecordFile:
    """MXIndexedRecordIO reader (dataset.py:84): random access by key."""

    def __init__(self, prefix: str):
        self.path_rec = prefix + ".rec"
        self.index = {}
        with open(prefix + ".idx") as f:
            for line in f:
                key, pos = line.split("\t")
                self.index[int(key)] = int(pos)
        self._f = open(self.path_rec, "rb")
        self._lock = threading.Lock()

    @property
    def keys(self):
        return sorted(self.index)

    def read_idx(self, key: int):
        """(flag, label, payload) for a record key."""
        with self._lock:
            self._f.seek(self.index[int(key)])
            magic, lrec = struct.unpack("<II", self._f.read(8))
            if magic != _MAGIC:
                raise ValueError(
                    f"bad record magic {magic:#x} at key {key} "
                    f"(corrupt {self.path_rec}?)")
            n = lrec & ((1 << 29) - 1)
            data = self._f.read(n)
        return _unpack_record(data)

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


class ArcFaceRecordDataset:
    """MXFaceDataset (dataset.py:70-107): JPEG faces + identity labels.

    Record 0 may be a header (flag>0) whose label is
    [num_records, num_identities] — then the image ids run 1..num_records-1
    (dataset.py:86-91)."""

    def __init__(self, root_dir: str, prefix: str = "train"):
        self.rec = RecordFile(os.path.join(root_dir, prefix))
        flag, label, _ = self.rec.read_idx(self.rec.keys[0])
        if flag > 0 and self.rec.keys[0] == 0:
            self.header0 = (int(label[0]), int(label[1]))
            self.imgidx = np.arange(1, int(label[0]))
        else:
            self.header0 = None
            self.imgidx = np.asarray(self.rec.keys)

    def __len__(self):
        return len(self.imgidx)

    @property
    def num_classes(self) -> Optional[int]:
        if self.header0 is None:
            return None
        return self.header0[1] - self.header0[0]

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        """(image [112,112,3] uint8 RGB, label int). Decode only — the
        flip/normalize augmentation happens in record_batches so the raw
        pixels stay cacheable."""
        from PIL import Image

        flag, label, payload = self.rec.read_idx(int(self.imgidx[index]))
        if flag > 0:
            label = label[0]  # multi-label records: first entry (dataset.py:98-99)
        img = np.asarray(
            Image.open(io.BytesIO(payload)).convert("RGB"), np.uint8)
        return img, int(label)


# ---------------------------------------------------------------------------
# distributed sampling + batching
# ---------------------------------------------------------------------------


def epoch_indices(n: int, epoch: int, index: int, count: int,
                  seed: int = 0, shuffle: bool = True) -> np.ndarray:
    """torch DistributedSampler semantics (train.py:42): shuffle all n
    indices with a (seed+epoch)-keyed generator, pad by wrapping to a
    multiple of ``count``, return the rank-strided slice."""
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    else:
        order = np.arange(n)
    total = int(np.ceil(n / count)) * count
    if total > n:
        order = np.concatenate([order, order[: total - n]])
    return order[index::count]


class _Prefetcher:
    """BackgroundGenerator (dataset.py:13-39): decode/augment the next
    batches on a daemon thread while the device trains. An exception in
    the thread is raised in the consumer when it reaches it."""

    _END = object()

    def __init__(self, gen, max_prefetch: int = 6):
        self.queue: _queue.Queue = _queue.Queue(max_prefetch)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(gen,), daemon=True)
        self._thread.start()

    def _run(self, gen):
        try:
            for item in gen:
                self.queue.put(item)
        except Exception as e:  # handed to the consumer
            self._error = e
        finally:
            self.queue.put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.queue.get()
        if item is self._END:
            self.queue.put(self._END)  # later calls stop too
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def record_batches(
    dataset: ArcFaceRecordDataset,
    batch_size: int,
    epoch: int = 0,
    index: Optional[int] = None,
    count: Optional[int] = None,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
    hflip: bool = True,
    prefetch: int = 6,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """This host's (images, labels) batches for one epoch.

    images [B,112,112,3] float32 in [-1,1] with random hflip — the
    MXFaceDataset transform (dataset.py:72-77); labels [B] int32.
    ``index``/``count`` default to this process's rank and the world size
    (``s2v_torch.parallel.hosts``: one process per card)."""
    from s2v_torch.parallel import hosts

    index = hosts.process_index() if index is None else index
    count = hosts.process_count() if count is None else count
    rng = rng or np.random.default_rng(seed * 100003 + epoch * 1009 + index)
    idxs = epoch_indices(len(dataset), epoch, index, count, seed=seed)

    def gen():
        for i in range(0, len(idxs), batch_size):
            sel = idxs[i : i + batch_size]
            if drop_last and len(sel) < batch_size:
                return
            imgs = np.empty((len(sel), 112, 112, 3), np.float32)
            labels = np.empty((len(sel),), np.int32)
            for j, k in enumerate(sel):
                img, lab = dataset[int(k)]
                if hflip and rng.uniform() < 0.5:
                    img = img[:, ::-1]
                imgs[j] = img
                labels[j] = lab
            yield (imgs / 255.0 - 0.5) / 0.5, labels

    return iter(_Prefetcher(gen(), prefetch)) if prefetch else gen()


def write_synthetic_pack(root_dir: str, num_identities: int = 8,
                         per_identity: int = 4, seed: int = 0,
                         prefix: str = "train") -> str:
    """Build a tiny valid pack (header0 + JPEG faces) — the
    SyntheticDataset analogue (dataset.py:110-124) but on-disk, so reader
    tests and smoke training exercise the real container path."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    os.makedirs(root_dir, exist_ok=True)
    n = num_identities * per_identity

    def records():
        # header0 label = [identity_range_start, identity_range_end] where
        # start == num image records + 1 (the insightface pack convention;
        # dataset.py:86-89 uses label[0] as the image id bound and
        # num_classes == label[1] - label[0])
        yield 0, np.asarray([n + 1, n + 1 + num_identities], np.float32), b""
        for i in range(n):
            img = (rs.rand(112, 112, 3) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=95)
            yield i + 1, float(i % num_identities), buf.getvalue()

    write_record_file(os.path.join(root_dir, prefix), records())
    return root_dir
