"""Classification task: dataset loading + accuracy evaluation.

The reference's classification path — CSV ``text,label`` dataset loader
(``Dataset.java:20-44``), binary-classification inference variant
(``cpp/inference.cpp:220-270``, JNI ``native-lib.cpp:1305-1366``) and the
accuracy loop in ``BackgroundService.java:233-245``.  A copy of
``distributed_inference_demo_tpu/tasks/classification.py``:
classification is a single KV-less prefill whose last-position logits
are restricted to one verbalizer token id per class and argmaxed
(``InferenceEngine.classify``; the pipeline's ``classify_many`` is not
ported yet).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from typing import Callable, List, Sequence

import numpy as np


@dataclass
class ClassificationDataset:
    """Parallel lists of texts and integer labels, plus the label names in
    index order (``label_names[labels[i]]`` is row i's original label)."""

    texts: List[str]
    labels: List[int]
    label_names: List[str] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.texts)


def load_csv_dataset(path: str, text_col: int = 0,
                     label_col: int = 1, skip_header: bool = False
                     ) -> ClassificationDataset:
    """Load a ``text,label`` CSV (the reference's eval format,
    ``Dataset.java:20-44``).  Labels may be ints or names; names are mapped
    to indices in first-seen order."""
    texts: List[str] = []
    raw_labels: List[str] = []
    with open(path, newline="") as f:
        for i, row in enumerate(csv.reader(f)):
            if not row or (skip_header and i == 0):
                continue
            texts.append(row[text_col])
            raw_labels.append(row[label_col].strip())

    names: List[str] = []
    index = {}
    labels = []
    for lab in raw_labels:
        if lab not in index:
            index[lab] = len(names)
            names.append(lab)
        labels.append(index[lab])
    return ClassificationDataset(texts=texts, labels=labels,
                                 label_names=names)


def evaluate_classifier(
    classify_fn: Callable[[np.ndarray], np.ndarray],
    prompts: Sequence[np.ndarray],
    labels: Sequence[int],
    batch_size: int = 8,
) -> dict:
    """Accuracy loop (reference ``BackgroundService.java:233-245``).

    ``classify_fn`` maps a [b, s] int32 prompt batch to [b] predicted label
    indices (``InferenceEngine.classify`` / ``PipelineHeader.classify_many``
    partials).  ``prompts`` is one [1, s] array per example (ragged lengths
    allowed — batches group equal-length prompts to keep shapes static for
    jit).  Returns {"accuracy", "correct", "total", "predictions"}.
    """
    if len(prompts) != len(labels):
        raise ValueError("prompts and labels must align")
    by_len: dict = {}
    for i, p in enumerate(prompts):
        p = np.asarray(p)
        if p.ndim == 1:
            p = p[None, :]
        by_len.setdefault(p.shape[1], []).append((i, p))

    preds = np.full(len(prompts), -1, np.int32)
    for _, group in sorted(by_len.items()):
        for start in range(0, len(group), batch_size):
            chunk = group[start:start + batch_size]
            batch = np.concatenate([p for _, p in chunk], axis=0)
            out = np.asarray(classify_fn(batch)).reshape(-1)
            for (i, _), pred in zip(chunk, out):
                preds[i] = pred

    labels_arr = np.asarray(labels, np.int32)
    correct = int((preds == labels_arr).sum())
    return {"accuracy": correct / max(1, len(labels)),
            "correct": correct, "total": len(labels),
            "predictions": preds.tolist()}
