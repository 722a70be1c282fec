"""On-device evaluation metrics, ported from the tensor functions of
``chestxray_vit_tpu/eval/metrics.py``: per-class AUROC (rank-sum with
midranks, sklearn's trapezoid AUC), its mean over valid classes, micro-F1
and per-class precision / recall / F1 at a threshold, all on the logits'
device. The host-side report (``classification_report``,
``calibrate_thresholds``, ``f1_micro_at``) waits for the trainer slice
(ROADMAP Queue 1 #4).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

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


def compute_metrics(logits: torch.Tensor, labels: torch.Tensor,
                    class_names: Optional[Sequence[str]] = None
                    ) -> Dict[str, float]:
    """avg_auroc and f1_micro (plus per-class AUROCs keyed by name when
    names are given) as Python floats, computed on the logits' device."""
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
