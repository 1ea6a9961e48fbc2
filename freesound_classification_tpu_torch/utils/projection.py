"""The self-supervised CLIs' representation probe (JAX
``utils/projection.py``): a 5-NN classifier's accuracy on a few frames of
each single-label clip's representation, and a TSNE scatter of them.

The JAX probe calls sklearn. The port computes the probe with numpy, as
sklearn does: ``train_test_split(shuffle=False, test_size=0.2)`` takes the
first ``n - ceil(0.2 n)`` rows to fit, ``StandardScaler`` divides by the
population standard deviation (1 where it is 0), and ``KNeighborsClassifier
(n_neighbors=5)`` votes among the 5 nearest fitted rows by Euclidean
distance, a tie going to the smallest class. The TSNE image is drawn with
matplotlib where it imports (else the probe says so in one line and goes
on, as on a failure of the plot itself); its embedding is the port's own
exact-gradient t-SNE in torch (``tsne_embedding``: sklearn ``TSNE()``'s
defaults, without its Barnes-Hut approximation), so the port needs no
sklearn.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch


def split_unshuffled(n: int, test_size: float = 0.2) -> int:
    """The number of leading rows sklearn's ``train_test_split(shuffle=
    False, test_size=test_size)`` keeps for training."""
    return n - math.ceil(test_size * n)


def standardize(fit: np.ndarray, *others: np.ndarray) -> list:
    """sklearn's ``StandardScaler().fit(fit)`` applied to ``fit`` and to
    each of ``others``."""
    mean = fit.mean(axis=0)
    scale = fit.std(axis=0)
    scale[scale == 0.0] = 1.0
    return [(x - mean) / scale for x in (fit, *others)]


def knn_predict(x_fit: np.ndarray, y_fit: np.ndarray, x: np.ndarray,
                k: int = 5) -> np.ndarray:
    """sklearn's ``KNeighborsClassifier(n_neighbors=k)`` fitted on (x_fit,
    y_fit), predicting x: the most frequent class among the k nearest
    fitted rows (Euclidean), ties to the smallest class."""
    x, x_fit = np.asarray(x, np.float64), np.asarray(x_fit, np.float64)
    d = ((x * x).sum(1)[:, None] - 2.0 * x @ x_fit.T
         + (x_fit * x_fit).sum(1)[None, :])
    nearest = np.argsort(d, axis=1, kind="stable")[:, :k]
    classes, y_idx = np.unique(y_fit, return_inverse=True)
    votes = np.zeros((len(x), len(classes)), np.int64)
    np.add.at(votes, (np.arange(len(x))[:, None], y_idx[nearest]), 1)
    return classes[np.argmax(votes, axis=1)]


def tsne_embedding(x: np.ndarray, perplexity: float = 30.0,
                   n_iter: int = 1000) -> np.ndarray:
    """(n, 2) t-SNE embedding of the rows of ``x`` with sklearn
    ``TSNE()``'s defaults (perplexity 30, early exaggeration 12 for 250
    steps, learning rate max(n / 48, 50), momentum 0.5 then 0.8, adaptive
    gains, PCA init scaled to std 1e-4) and exact gradients, in float64
    torch on the CPU. The perplexity is capped below n / 3."""
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    n = x.shape[0]
    d = torch.cdist(x, x) ** 2
    eye = torch.eye(n, dtype=torch.bool)
    target = math.log(min(perplexity, max((n - 1) / 3.0, 1.0)))
    beta = torch.ones(n, dtype=torch.float64)
    lo = torch.zeros(n, dtype=torch.float64)
    hi = torch.full((n,), math.inf, dtype=torch.float64)
    for _ in range(100):  # each row's precision for its perplexity
        p = torch.exp(-(d - d.masked_fill(eye, math.inf).amin(1, True))
                      * beta[:, None]).masked_fill(eye, 0.0)
        total = p.sum(1)
        entropy = torch.log(total) + beta * (d * p).sum(1) / total \
            - beta * d.masked_fill(eye, math.inf).amin(1)
        high = entropy > target
        lo = torch.where(high, beta, lo)
        hi = torch.where(high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2, (lo + hi) / 2)
    p = p / p.sum(1, keepdim=True)
    p = ((p + p.T) / (2 * n)).clamp(min=1e-12)
    centred = x - x.mean(0)
    y = centred @ torch.linalg.svd(centred, full_matrices=False)[2][:2].T
    y = y / y[:, 0].std() * 1e-4
    lr = max(n / 48.0, 50.0)
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    for step in range(n_iter):
        exaggeration, momentum = (12.0, 0.5) if step < 250 else (1.0, 0.8)
        num = 1.0 / (1.0 + torch.cdist(y, y) ** 2)
        num = num.masked_fill(eye, 0.0)
        q = (num / num.sum()).clamp(min=1e-12)
        w = (exaggeration * p - q) * num
        grad = 4.0 * (w.sum(1, keepdim=True) * y - w @ y)
        same = (update * grad) > 0
        gains = torch.where(same, gains * 0.8, gains + 0.2).clamp(min=0.01)
        update = momentum * update - lr * gains * grad
        y = y + update
    return y.numpy()


def tsne_image(representations: np.ndarray, classes) -> Optional[np.ndarray]:
    """The t-SNE scatter as an RGBA array, or None (with one line printed)
    where matplotlib does not import or the plot fails."""
    try:
        import matplotlib
    except ImportError as err:
        print(f"TSNE plot skipped: {err}")
        return None
    try:
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        embeddings = tsne_embedding(representations)
        fig = plt.figure(figsize=(10, 10))
        ax = fig.add_subplot(111)
        ax.scatter(embeddings[:, 0], embeddings[:, 1], c=classes, s=10)
        fig.canvas.draw()
        image = np.asarray(fig.canvas.renderer.buffer_rgba())
        plt.close(fig)
        return image
    except Exception as err:  # a diagnostic never stops training
        print(f"TSNE plot skipped: {err}")
        return None


def plot_projection(vectors, labels, frames_per_example: int = 3,
                    newline: bool = False, seed: int = 0) -> tuple:
    """(image or None, 5-NN accuracy) of per-clip frame representations
    ``vectors`` with multi-hot ``labels`` (JAX ``plot_projection``):
    multi-label clips are skipped, ``frames_per_example`` frames of each
    other clip drawn without replacement from ``RandomState(seed)``; fewer
    than 10 frames give (None, nan)."""
    rng = np.random.RandomState(seed)
    representations, classes = [], []
    for sample, label in zip(vectors, labels):
        if label.sum() != 1:
            continue
        n = len(sample)
        choices = rng.choice(np.arange(n), replace=False,
                             size=min(frames_per_example, n))
        representations.extend(np.asarray(sample)[choices])
        classes.extend([int(np.argmax(label))] * len(choices))
    if len(representations) < 10:
        return None, float("nan")
    representations = np.asarray(representations)
    classes = np.asarray(classes)
    n_fit = split_unshuffled(len(representations))
    x_fit, x_valid = standardize(representations[:n_fit],
                                 representations[n_fit:])
    predicted = knn_predict(x_fit, classes[:n_fit], x_valid)
    score = float(np.mean(predicted == classes[n_fit:]))
    if newline:
        print()
    print(f"Classification accuracy: {score:.4f}")
    return tsne_image(representations, classes), score


def projection_summary(engine, loader, summaries_dir: str, fold: int
                       ) -> Optional[float]:
    """Each clip's valid frames of the engine's model ``output`` (eval
    mode) over ``loader``, probed by ``plot_projection`` (5 frames a
    clip); the image, where there is one, goes to
    ``projection_fold{fold}.png`` in ``summaries_dir``. Returns the
    accuracy, or None for a model without an ``output``."""
    outputs, labels = [], []
    engine.model.eval()
    with torch.inference_mode():
        for batch in loader:
            wave, lengths, _ = engine.to_device(batch)
            out = engine.model(*engine.frontend(wave, lengths))
            if "output" not in out:
                return None
            reps = out["output"].float().cpu().numpy()
            samples = np.asarray(batch["lengths"])
            per_frame = max(1, batch["signal"].shape[1] // reps.shape[1])
            for i in range(len(reps)):
                valid = max(int(samples[i]) // per_frame, 1)
                outputs.append(reps[i, :min(valid, reps.shape[1])])
            labels.extend(np.asarray(batch["labels"]))
    image, score = plot_projection(outputs, np.asarray(labels),
                                   frames_per_example=5, newline=True)
    if image is not None:
        from matplotlib import pyplot as plt

        plt.imsave(os.path.join(summaries_dir, f"projection_fold{fold}.png"),
                   image)
    return score
