"""Adversarial validation (JAX ``cli/adversarial_test.py``): train a
discriminator of train clips against test clips and report its validation
AUC each epoch, per-frame probability plots and each class's mean domain
score. An AUC near 0.5 says the two sets cannot be told apart.

    python -m freesound_classification_tpu_torch.cli.adversarial_test \\
        --train_df train.csv --train_data_dir train \\
        --test_df sample_submission.csv --test_data_dir test \\
        --classmap classmap.json --features mel_2048_1024_128 \\
        [--device cuda] [--epochs 5] ...

The JAX CLI calls sklearn's ``roc_auc_score`` and ``train_test_split``;
the port computes both with numpy (``roc_auc``: the rank statistic with
ties at their mean rank; the split: ``common.holdout_rows`` with seed 42,
sklearn's rows). ``--max_samples`` draws its rows with
``common.sample_rows`` from seed ``MAX_SAMPLES_SEED`` where JAX's
``df.sample(n)`` draws them unseeded. Training is Adam at ``--lr`` on the
binary cross-entropy of the clip score clipped to [1e-6, 1 - 1e-6], the
log-mel frontend (K1) before the model. The plots are written where
matplotlib imports; the per-class table is printed as two columns.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.data.dataset import (
    ClipDataset,
    class_names_from_classmap,
    load_classmap,
    read_csv_columns,
)
from freesound_classification_tpu_torch.data.folds import (
    binarize_label_strings,
)
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.adversarial import (
    DomainDiscriminator,
)
from freesound_classification_tpu_torch.models.blocks import init_like_flax
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.utils.device import resolve_device

MAX_SAMPLES_SEED = 42
SPLIT_SEED = 42  # the JAX CLI's train_test_split random_state


def roc_auc(y_true, scores) -> float:
    """sklearn's ``roc_auc_score`` for binary labels: the Mann-Whitney
    statistic, each score's rank the mean rank of its ties, over the
    positive-negative pairs."""
    y = np.asarray(y_true) > 0.5
    s = np.asarray(scores, np.float64)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc: need both classes in y_true")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), np.float64)
    sorted_s = s[order]
    # the mean 1-based rank of each run of equal scores
    starts = np.flatnonzero(np.r_[True, sorted_s[1:] != sorted_s[:-1]])
    ends = np.r_[starts[1:], len(s)]
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    u = ranks[y].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def main(argv=None) -> dict:
    """Run the test; returns {"auc": per-epoch AUCs, "classes": names,
    "mean_scores": per-class mean domain scores}."""
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add = parser.add_argument
    add("--train_df", required=True, type=str)
    add("--train_data_dir", required=True, type=str)
    add("--test_df", required=True, type=str)
    add("--test_data_dir", required=True, type=str)
    add("--classmap", required=True, type=str)
    add("--features", required=True, type=str)
    add("--batch_size", type=int, default=32)
    add("--lr", type=float, default=1e-3)
    add("--epochs", type=int, default=5)
    add("--max_audio_length", type=int, default=10)
    add("--max_samples", type=int, default=None)
    add("--val_size", type=float, default=0.2)
    add("--batches_to_save", type=int, default=2)
    add("--plots_dir", type=str, default="plots")
    add("--num_workers", type=int, default=4)
    add("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    train_names, train_labels = read_csv_columns(args.train_df,
                                                 ["fname", "labels"])
    test_names = read_csv_columns(args.test_df, ["fname"])[0]
    if args.max_samples:
        rows = common.sample_rows(len(train_names), args.max_samples,
                                  MAX_SAMPLES_SEED)
        train_names = [train_names[i] for i in rows]
        train_labels = [train_labels[i] for i in rows]
        test_names = [test_names[i] for i in common.sample_rows(
            len(test_names), min(args.max_samples, len(test_names)),
            MAX_SAMPLES_SEED)]
    train_files = [os.path.join(args.train_data_dir, f) for f in train_names]
    test_files = [os.path.join(args.test_data_dir, f) for f in test_names]
    files = np.array(train_files + test_files)
    domain = np.concatenate([np.ones(len(train_files)),
                             np.zeros(len(test_files))]).astype(np.float32)
    tr_rows, va_rows = common.holdout_rows(len(files), args.val_size,
                                           SPLIT_SEED)
    tr_files, va_files = files[tr_rows], files[va_rows]
    tr_dom, va_dom = domain[tr_rows], domain[va_rows]

    frontend = Frontend(args.features, "1d", sr=common.SR, device=device)
    model = DomainDiscriminator(frontend.n_features)
    init_like_flax(model, torch.Generator().manual_seed(0))
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    ladder = common.default_ladder(args.max_audio_length)

    def loader(fs, train):
        ds = ClipDataset(list(fs), max_audio_length=args.max_audio_length,
                         sr=common.SR)
        return make_loader(ds, ladder, batch_size=args.batch_size,
                           train=train, num_workers=args.num_workers)

    def features(batch):
        wave = torch.as_tensor(batch["signal"], device=device)
        lengths = torch.as_tensor(batch["lengths"], device=device)
        with torch.no_grad():
            return frontend(wave, lengths)

    @torch.inference_mode()
    def scores(batch):
        model.eval()
        out = model(*features(batch))
        return out["domain_prob"], out["frame_probs"]

    tr_loader, va_loader = loader(tr_files, True), loader(va_files, False)
    aucs = []
    for epoch in range(args.epochs):
        model.train()
        for batch in tr_loader:
            dom = torch.as_tensor(tr_dom[batch["index"]], device=device)
            probs = model(*features(batch))["domain_prob"].clamp(
                1e-6, 1 - 1e-6)
            loss = -(dom * torch.log(probs)
                     + (1 - dom) * torch.log(1 - probs)).mean()
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        val_probs, val_dom = [], []
        for batch in va_loader:
            val_probs.extend(scores(batch)[0].float().cpu().numpy())
            val_dom.extend(va_dom[batch["index"]])
        aucs.append(roc_auc(val_dom, val_probs))
        print(f"\nEpoch: {epoch}, AUC: {aucs[-1]}")

    save_frame_plots(args, va_loader, va_dom, scores, features)

    # each class's mean domain score over the validation clips from train
    class_map = load_classmap(args.classmap)
    class_names = class_names_from_classmap(class_map)
    train_set = set(train_files)
    named = [f for f in va_files if f in train_set]
    mean_scores = np.full(len(class_names), np.nan)
    if named:
        lookup = dict(zip(train_names, train_labels))
        labels = binarize_label_strings(
            [str(lookup[os.path.basename(f)]) for f in named], class_map)
        all_probs = np.zeros(len(named))
        for batch in loader(named, False):
            all_probs[batch["index"]] = scores(batch)[0].float().cpu().numpy()
        with np.errstate(invalid="ignore"):
            mean_scores = ((labels * all_probs[:, None]).sum(0)
                           / np.maximum(labels.sum(0), 1))
        print()
        width = max(len(n) for n in class_names)
        print(f"{'classname':<{width}}  scores")
        for name, score in zip(class_names, mean_scores):
            print(f"{name:<{width}}  {score:.6f}")
    return {"auc": aucs, "classes": class_names, "mean_scores": mean_scores}


def save_frame_plots(args, va_loader, va_dom, scores, features) -> None:
    """For ``--batches_to_save`` validation batches, each clip's features
    above its per-frame domain probabilities, as PNGs in ``--plots_dir``,
    where matplotlib imports (JAX's plots)."""
    os.makedirs(args.plots_dir, exist_ok=True)
    try:
        import matplotlib
    except ImportError as err:
        print(f"plots skipped: {err}")
        return
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    for saved, batch in enumerate(va_loader):
        if saved >= args.batches_to_save:
            break
        probs, frame_probs = scores(batch)
        inputs, _ = features(batch)
        for k in range(len(probs)):
            fig = plt.figure(figsize=(20, 7))
            fig.suptitle(str(va_dom[batch["index"][k]]))
            ax = fig.add_subplot(211)
            ax.imshow(inputs[k].float().cpu().numpy().T, aspect="auto")
            ax = fig.add_subplot(212)
            ax.plot(frame_probs[k].float().cpu().numpy())
            ax.set_ylim(0, 1)
            fig.savefig(os.path.join(args.plots_dir,
                                     f"plot_{saved}_{k}.png"))
            plt.close(fig)


if __name__ == "__main__":
    common.log_launches_at_exit()
    main()
