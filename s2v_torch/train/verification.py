"""Face-verification evaluation (reference:
arcface_torch/eval/verification.py:54-197 + the CallBackVerification hook,
utils/utils_callbacks.py:12-49, and eval_ijbc.py's template protocol;
s2v_tpu/train/verification.py): LFW-style pair verification with k-fold
threshold selection, plus the flip-augmented embedding extraction.

Vectorized numpy (the distance/threshold sweep is a [T, N] broadcast, not
the reference's per-threshold loop); the embedding forward runs on the
model's device in fixed-size batches (the last one padded).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from s2v_torch.device import resolve_device


def _kfold_indices(n: int, k: int):
    """sklearn KFold(shuffle=False) split boundaries."""
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    edges = np.concatenate([[0], np.cumsum(sizes)])
    for i in range(k):
        test = np.arange(edges[i], edges[i + 1])
        train = np.concatenate([np.arange(0, edges[i]), np.arange(edges[i + 1], n)])
        yield train, test


def calculate_accuracy(threshold: float, dist: np.ndarray, issame: np.ndarray):
    """verification.py:109-121."""
    predict = dist < threshold
    tp = np.sum(predict & issame)
    fp = np.sum(predict & ~issame)
    tn = np.sum(~predict & ~issame)
    fn = np.sum(~predict & issame)
    tpr = 0.0 if tp + fn == 0 else tp / (tp + fn)
    fpr = 0.0 if fp + tn == 0 else fp / (fp + tn)
    return tpr, fpr, (tp + tn) / dist.size


def calculate_roc(thresholds, emb1, emb2, issame, nrof_folds: int = 10):
    """verification.py:54-106, vectorized over thresholds."""
    n = min(len(issame), emb1.shape[0])
    dist = np.sum(np.square(emb1 - emb2), axis=1)[:n]
    issame = np.asarray(issame[:n], bool)
    thr = np.asarray(thresholds)

    # [T, N] prediction matrix
    pred = dist[None, :] < thr[:, None]
    accuracy = np.zeros(nrof_folds)
    tprs = np.zeros((nrof_folds, len(thr)))
    fprs = np.zeros((nrof_folds, len(thr)))
    for fold, (train, test) in enumerate(_kfold_indices(n, nrof_folds)):
        acc_train = (pred[:, train] == issame[None, train]).mean(axis=1)
        best = int(np.argmax(acc_train))
        for t in range(len(thr)):
            tprs[fold, t], fprs[fold, t], _ = calculate_accuracy(
                thr[t], dist[test], issame[test]
            )
        _, _, accuracy[fold] = calculate_accuracy(
            thr[best], dist[test], issame[test]
        )
    return tprs.mean(0), fprs.mean(0), accuracy


def evaluate(embeddings: np.ndarray, issame: np.ndarray,
             nrof_folds: int = 10):
    """verification.py:179-197 (ROC part). embeddings: [2N, E] with pairs
    interleaved; issame: [N] bool. Returns (accuracy_mean, accuracy_std)."""
    thresholds = np.arange(0, 4, 0.01)
    _, _, acc = calculate_roc(
        thresholds, embeddings[0::2], embeddings[1::2], issame, nrof_folds
    )
    return float(acc.mean()), float(acc.std())


def extract_embeddings(embed_fn: Callable, images: np.ndarray,
                       batch: int = 64, flip: bool = True, device=None) -> np.ndarray:
    """CallBackVerification's flip-augmented embeddings
    (verification.py test(): emb(img) + emb(flip(img)), then L2-normalize).
    ``images`` [N, H, W, 3] NHWC; ``embed_fn`` takes a [batch, 3, H, W]
    tensor on ``device`` (the card unless the caller asks for the CPU) and
    returns [batch, E]; the flip is the batch's width axis. Runs without
    autograd."""
    dev = resolve_device(device)

    def embed(chunk):
        x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(dev)
        return embed_fn(x.permute(0, 3, 1, 2)).float().cpu().numpy()

    out = None
    n = len(images)
    with torch.no_grad():
        for i in range(0, n, batch):
            chunk = images[i : i + batch]
            pad = batch - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            emb = embed(chunk)
            if flip:
                emb = emb + embed(chunk[:, :, ::-1])
            if out is None:
                out = np.zeros((n, emb.shape[1]), np.float32)
            out[i : i + batch - pad] = emb[: batch - pad]
    out /= np.linalg.norm(out, axis=1, keepdims=True) + 1e-12
    return out


class VerificationCallback:
    """CallBackVerification (utils_callbacks.py:12-49): run pair-verification
    every `frequent` steps, track the best accuracy. ``device`` is
    ``extract_embeddings``'."""

    def __init__(self, images: np.ndarray, issame: np.ndarray,
                 frequent: int = 2000, name: str = "val", device=None):
        self.images = images
        self.device = device
        self.issame = issame
        self.frequent = frequent
        self.name = name
        self.best_acc = 0.0

    def __call__(self, step: int, embed_fn: Callable) -> Optional[dict]:
        if step % self.frequent != 0 or step == 0:
            return None
        emb = extract_embeddings(embed_fn, self.images, device=self.device)
        acc, std = evaluate(emb, self.issame)
        self.best_acc = max(self.best_acc, acc)
        return {"step": step, f"{self.name}_acc": acc,
                f"{self.name}_std": std, "best_acc": self.best_acc}


# ---------------------------------------------------------------------------
# IJB-C protocol (reference: arcface_torch/eval_ijbc.py:212-290)
# ---------------------------------------------------------------------------


def image2template_feature(img_feats: np.ndarray, templates: np.ndarray,
                           medias: np.ndarray):
    """eval_ijbc.py:212-249: pool image features to media features (videos
    average), then media features to L2-normalized template features.

    Returns (template_feats [T, E], unique_templates [T])."""
    unique_templates = np.unique(templates)
    template_feats = np.zeros((len(unique_templates), img_feats.shape[1]))
    for count, uqt in enumerate(unique_templates):
        (ind_t,) = np.where(templates == uqt)
        face_feats = img_feats[ind_t]
        face_medias = medias[ind_t]
        uniq_m, uniq_ct = np.unique(face_medias, return_counts=True)
        media_feats = []
        for u, ct in zip(uniq_m, uniq_ct):
            (ind_m,) = np.where(face_medias == u)
            if ct == 1:
                media_feats.append(face_feats[ind_m])
            else:
                media_feats.append(face_feats[ind_m].mean(0, keepdims=True))
        media_feats = np.concatenate(media_feats, 0)
        template_feats[count] = media_feats.sum(0)
    norm = np.linalg.norm(template_feats, axis=1, keepdims=True) + 1e-12
    return template_feats / norm, unique_templates


def template_verification_scores(template_feats: np.ndarray,
                                 unique_templates: np.ndarray,
                                 p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """eval_ijbc.py:252-279: cosine score per template pair."""
    template2id = np.zeros(int(unique_templates.max()) + 1, np.int64)
    template2id[unique_templates] = np.arange(len(unique_templates))
    f1 = template_feats[template2id[p1]]
    f2 = template_feats[template2id[p2]]
    return np.sum(f1 * f2, -1)


def tar_at_far(scores: np.ndarray, labels: np.ndarray,
               far_targets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)):
    """ROC points the IJB-C table reports: TAR at fixed FARs."""
    scores = np.asarray(scores)
    labels = np.asarray(labels, bool)
    neg = np.sort(scores[~labels])[::-1]
    pos = scores[labels]
    out = {}
    for far in far_targets:
        k = max(int(far * len(neg)), 1) - 1
        if len(neg) == 0:
            out[far] = 1.0
            continue
        thr = neg[min(k, len(neg) - 1)]
        out[far] = float(np.mean(pos > thr))
    return out
