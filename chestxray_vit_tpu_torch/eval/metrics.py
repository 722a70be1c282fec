"""Evaluation metrics, ported from ``chestxray_vit_tpu/eval/metrics.py``.

On the logits' device: per-class AUROC (rank-sum with midranks, sklearn's
trapezoid AUC), its mean over valid classes, micro-F1 and per-class
precision / recall / F1 at a threshold (``compute_metrics`` takes tensors
or numpy arrays). On the host, in numpy f64 as the JAX package computes
them: per-class decision thresholds fitted on a validation split
(``calibrate_thresholds``), sklearn's text ``classification_report`` and
the micro-F1 at scalar or per-class thresholds (``f1_micro_at``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def auroc_per_class(scores: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """[N, C] scores (any monotone of probability: logits work) and {0, 1}
    labels → [C] f32 AUROCs, NaN for a class whose labels are constant.

    AUC = (Σ ranks(positives) − n⁺(n⁺+1)/2) / (n⁺ n⁻), with 1-based ranks
    and tied scores sharing their average rank, found by binary search
    (left and right) in the sorted column."""
    s = scores.float().t().contiguous()            # [C, N]
    y = labels.float().t()
    n = s.shape[1]
    sorted_s = torch.sort(s, dim=1).values
    lo = torch.searchsorted(sorted_s, s, side="left")
    hi = torch.searchsorted(sorted_s, s, side="right")
    ranks = (lo + hi + 1).float() / 2.0
    n_pos = y.sum(dim=1)
    n_neg = n - n_pos
    rank_sum = (ranks * y).sum(dim=1)
    auc = (rank_sum - n_pos * (n_pos + 1.0) / 2.0) / (n_pos * n_neg)
    degenerate = (n_pos == 0) | (n_neg == 0)
    return torch.where(degenerate, torch.full_like(auc, float("nan")), auc)


def avg_auroc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean AUROC over valid (non-degenerate) classes; 0.0 when none is."""
    per_class = auroc_per_class(scores, labels)
    valid = ~torch.isnan(per_class)
    total = torch.where(valid, per_class, 0.0).sum()
    count = valid.sum()
    return torch.where(count > 0, total / count.clamp(min=1), 0.0)


def _confusion(logits: torch.Tensor, labels: torch.Tensor, threshold: float,
               dim=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pred = (torch.sigmoid(logits.float()) >= threshold).float()
    lab = labels.float()
    reduce = (lambda t: t.sum()) if dim is None else (lambda t: t.sum(dim))
    return (reduce(pred * lab), reduce(pred * (1.0 - lab)),
            reduce((1.0 - pred) * lab))


def _safe(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, 0 where den is 0 (zero_division=0)."""
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def f1_micro(logits: torch.Tensor, labels: torch.Tensor,
             threshold: float = 0.5) -> torch.Tensor:
    """sigmoid → ≥ threshold → micro-F1, zero_division=0."""
    tp, fp, fn = _confusion(logits, labels, threshold)
    return _safe(2.0 * tp, 2.0 * tp + fp + fn)


def precision_recall_f1_per_class(logits: torch.Tensor, labels: torch.Tensor,
                                  threshold: float = 0.5):
    """Per-class (precision, recall, f1, support), zero_division=0."""
    tp, fp, fn = _confusion(logits, labels, threshold, dim=0)
    precision = _safe(tp, tp + fp)
    recall = _safe(tp, tp + fn)
    f1 = _safe(2 * precision * recall, precision + recall)
    return precision, recall, f1, labels.float().sum(dim=0)


def compute_metrics(logits, labels,
                    class_names: Optional[Sequence[str]] = None
                    ) -> Dict[str, float]:
    """avg_auroc and f1_micro (plus per-class AUROCs keyed by name when
    names are given) as Python floats, computed on the logits' device
    (the CPU for numpy arrays)."""
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels)
    per_class = auroc_per_class(logits, labels)
    valid = ~torch.isnan(per_class)
    out: Dict[str, float] = {
        "avg_auroc": (float(per_class[valid].mean()) if bool(valid.any())
                      else 0.0),
        "f1_micro": float(f1_micro(logits, labels)),
    }
    if class_names is not None:
        for name, auc in zip(class_names, per_class.tolist()):
            out[f"auroc_{name}"] = float(auc)
    return out


# ---------------------------------------------------------------------------
# Host-side thresholds and report (numpy f64)
# ---------------------------------------------------------------------------

def calibrate_thresholds(logits: np.ndarray, labels: np.ndarray
                         ) -> np.ndarray:
    """Per-class decision thresholds maximizing per-class F1 on a held-out
    (validation) set — the principled replacement for the fixed 0.5 the
    reference's report uses (ViT-Training.py:139), which is usually far
    from optimal for imbalanced multi-label targets.

    Exact sweep per class in O(N log N): sort probabilities descending;
    predicting the top-k flips one sample at a time, so
    F1(k) = 2·tp_k / (k + P) with tp_k a cumulative sum. The returned
    threshold is the midpoint between the k-th and (k+1)-th probability.
    Degenerate classes (no positives) keep 0.5.
    """
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, dtype=np.float64)))
    lab = np.asarray(labels).astype(np.float64)
    n, c = probs.shape
    out = np.full(c, 0.5)
    for j in range(c):
        pos = lab[:, j].sum()
        if pos == 0 or n == 0:
            continue
        order = np.argsort(-probs[:, j])
        p_sorted = probs[order, j]
        tp = np.cumsum(lab[order, j])
        k = np.arange(1, n + 1)
        # only cuts at tie-block boundaries are realizable by a threshold:
        # a midpoint inside a run of equal probabilities degenerates to the
        # tied value itself, and `>=` then includes the WHOLE block — the
        # realized F1 would differ from the computed one (ties are real:
        # f64 sigmoid saturates to exactly 1.0 for logits ≳ 36.7)
        realizable = np.empty(n, dtype=bool)
        realizable[:-1] = p_sorted[:-1] > p_sorted[1:]
        realizable[-1] = True
        f1 = np.where(realizable, 2.0 * tp / (k + pos), -1.0)
        best = int(np.argmax(f1))
        lo = p_sorted[best]
        hi = p_sorted[best + 1] if best + 1 < n else 0.0
        out[j] = (lo + hi) / 2.0
    return out


# ---------------------------------------------------------------------------
# Host-side classification report (sklearn's text format)
# ---------------------------------------------------------------------------

def classification_report(logits: np.ndarray, labels: np.ndarray,
                          class_names: Sequence[str],
                          threshold: "float | np.ndarray" = 0.5) -> str:
    """sklearn-style multilabel classification report text
    (ViT-Training.py:145-148 writes this to final_classification_report.txt).
    Rows: per-class precision/recall/f1/support; footer: micro, macro,
    weighted and samples averages. One prediction array (f64 sigmoid on
    host, like sklearn's caller-side thresholding) feeds every row — mixing
    the device's f32 sigmoid for per-class rows with f64 for the footer can
    disagree on boundary logits and print an internally inconsistent
    report."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, dtype=np.float64)))
    # threshold broadcasts: scalar (reference 0.5) or per-class [C]
    # (calibrate_thresholds output)
    pred = (probs >= np.asarray(threshold)).astype(np.int64)
    lab = np.asarray(labels).astype(np.int64)
    tp_c = (pred * lab).sum(0).astype(np.float64)
    fp_c = (pred * (1 - lab)).sum(0).astype(np.float64)
    fn_c = ((1 - pred) * lab).sum(0).astype(np.float64)
    safe = lambda num, den: np.where(den > 0, num / np.maximum(den, 1), 0.0)
    p = safe(tp_c, tp_c + fp_c)
    r = safe(tp_c, tp_c + fn_c)
    f1 = np.where(p + r > 0, 2 * p * r / np.maximum(p + r, 1e-12), 0.0)
    sup = lab.sum(0)

    name_w = max(len(n) for n in class_names)
    width = max(name_w, len("weighted avg"))
    head = f"{'':>{width}}  precision    recall  f1-score   support\n\n"
    lines = [head]
    for i, name in enumerate(class_names):
        lines.append(f"{name:>{width}}  {p[i]:9.2f} {r[i]:9.2f} {f1[i]:9.2f}"
                     f" {int(sup[i]):9d}\n")
    lines.append("\n")

    tp = float((pred * lab).sum())
    fp = float((pred * (1 - lab)).sum())
    fn = float(((1 - pred) * lab).sum())
    micro_p = tp / (tp + fp) if tp + fp else 0.0
    micro_r = tp / (tp + fn) if tp + fn else 0.0
    micro_f = (2 * micro_p * micro_r / (micro_p + micro_r)
               if micro_p + micro_r else 0.0)
    total = int(sup.sum())
    macro = (p.mean(), r.mean(), f1.mean())
    wsum = sup.sum() if sup.sum() else 1.0
    weighted = ((p * sup).sum() / wsum, (r * sup).sum() / wsum,
                (f1 * sup).sum() / wsum)
    # samples average (sklearn's 4th footer row for multilabel targets)
    inter = (pred & lab).sum(1).astype(np.float64)
    psz = pred.sum(1).astype(np.float64)
    lsz = lab.sum(1).astype(np.float64)
    sp = np.where(psz > 0, inter / np.maximum(psz, 1), 0.0)
    sr = np.where(lsz > 0, inter / np.maximum(lsz, 1), 0.0)
    sf = np.where(sp + sr > 0, 2 * sp * sr / np.maximum(sp + sr, 1e-12), 0.0)

    for tag, (pp, rr, ff) in (("micro avg", (micro_p, micro_r, micro_f)),
                              ("macro avg", macro),
                              ("weighted avg", weighted),
                              ("samples avg", (sp.mean(), sr.mean(),
                                               sf.mean()))):
        lines.append(f"{tag:>{width}}  {pp:9.2f} {rr:9.2f} {ff:9.2f}"
                     f" {total:9d}\n")
    return "".join(lines)


def write_classification_report(path: str, logits: np.ndarray,
                                labels: np.ndarray,
                                class_names: Sequence[str],
                                threshold: "float | np.ndarray" = 0.5
                                ) -> str:
    text = classification_report(logits, labels, class_names, threshold)
    if np.ndim(threshold) > 0:
        text += ("\ncalibrated per-class thresholds: "
                 + ", ".join(f"{n}={t:.3f}"
                             for n, t in zip(class_names,
                                             np.asarray(threshold))) + "\n")
    with open(path, "w") as f:
        f.write(text)
    return text


def f1_micro_at(logits: np.ndarray, labels: np.ndarray,
                threshold: "float | np.ndarray") -> float:
    """Host micro-F1 at a scalar or per-class threshold (f64 sigmoid,
    matching the report's own thresholding)."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, dtype=np.float64)))
    pred = (probs >= np.asarray(threshold)).astype(np.int64)
    lab = np.asarray(labels).astype(np.int64)
    tp = float((pred * lab).sum())
    fp = float((pred * (1 - lab)).sum())
    fn = float(((1 - pred) * lab).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0
