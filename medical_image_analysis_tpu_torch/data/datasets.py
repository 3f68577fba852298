"""Annotation parsing, fixed-shape batching and context-sample retrieval.

Counterpart of the parts of ``medical_image_analysis_tpu/data/datasets.py``
that ``fit_mrg`` reaches for ``task=r2gengpt`` and ``task=r2gencsr``:
``Sample``, ``load_annotations`` (annotation.json with train/val/test
splits of {id, report, image_path[...]} records), ``drop_unclear_reports``,
``load_chexbert_csv``, ``context_index_split``, ``draw_context_ids``,
``sample_context_ids``, ``group_study_two_views``, ``MRGBatcher`` (with
R2GenCSR's positive/negative context exemplars), ``prefetch`` and the
image loaders. Every batch has the same shapes (views padded by
repetition, reports padded to ``max_len``), as in the JAX package, and
the same seed draws the same samples and context ids.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue as queue_mod
import threading
from typing import Iterator

import numpy as np

from .preprocessing import decode_scaled, host_preprocess
from .report_cleaning import clean_report
from .tokenizer import WordTokenizer

# R2GenCSR splits its context exemplars on this disease keyword
DEFAULT_CONTEXT_KEYWORD = "effusion"


@dataclasses.dataclass
class Sample:
    id: str
    image_paths: list[str]
    report: str
    study_id: str | None = None
    # Draft report from an earlier model pass (MAC-RRG `Draft_text`).
    draft: str | None = None


def load_annotations(path: str, dataset: str) -> dict[str, list[Sample]]:
    with open(path) as f:
        ann = json.load(f)
    out = {}
    for split in ("train", "val", "test"):
        samples = []
        for rec in ann.get(split, []):
            report = rec.get("report") or rec.get("image_finding") or ""
            report = clean_report(report, dataset)
            paths = rec.get("image_path") or []
            if isinstance(paths, str):
                paths = [paths]
            samples.append(Sample(
                str(rec.get("id")), paths, report,
                study_id=(
                    str(rec["study_id"]) if "study_id" in rec else None
                ),
                draft=rec.get("Draft_text"),
            ))
        out[split] = samples
    return out


def drop_unclear_reports(samples: list[Sample], min_words: int = 3):
    """Remove degenerate reports (too short to describe findings)."""
    return [s for s in samples if len(s.report.split()) >= min_words]


def load_chexbert_csv(path: str) -> dict[str, np.ndarray]:
    """ann_chexbert.csv (id + 14 label columns) -> {id: (14,) int labels},
    with -1 and blanks mapped to 0."""
    import csv

    out = {}
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        cols = [c for c in reader.fieldnames if c not in ("id", "image_path")]
        for row in reader:
            vals = []
            for c in cols:
                v = row.get(c, "")
                try:
                    v = float(v)
                except (TypeError, ValueError):
                    v = 0.0
                vals.append(1 if v == 1 else 0)
            out[str(row.get("id"))] = np.asarray(vals, np.int32)
    return out


def context_index_split(
    samples: list[Sample],
    mode: str = "keyword",
    keyword: str | list[str] = DEFAULT_CONTEXT_KEYWORD,
    chexbert_labels: dict[str, np.ndarray] | None = None,
) -> tuple[list[int], list[int]] | None:
    """The (positive, negative) index split of ``samples``, computed once.

    ``random`` mode has no split (None); ``keyword`` splits on the
    presence of a keyword in the report; ``chexbert`` on the no-finding
    column of a CheXbert csv (positives: any finding), with the rule
    labeler for samples the csv lacks. An empty side falls back to all
    samples.
    """
    if mode == "random":
        return None
    if mode == "chexbert":
        from ..evalx.chexbert import extract_labels

        def no_finding(s: Sample) -> bool:
            if chexbert_labels is not None and s.id in chexbert_labels:
                return bool(chexbert_labels[s.id][-1] == 1)
            return bool(extract_labels(s.report)[-1] == 1)

        flags = [no_finding(s) for s in samples]
    else:
        kws = [keyword] if isinstance(keyword, str) else list(keyword)
        flags = [not any(k in s.report for k in kws) for s in samples]
    pos = [i for i, f in enumerate(flags) if not f]
    neg = [i for i, f in enumerate(flags) if f]
    everything = list(range(len(samples)))
    return pos or everything, neg or everything


def draw_context_ids(
    rng: np.random.Generator,
    split: tuple[list[int], list[int]] | None,
    n_samples: int,
    n: int,
) -> tuple[list[int], list[int]]:
    """``n`` positive and ``n`` negative ids for one study, from a split of
    :func:`context_index_split` (uniform over all samples without one)."""
    if split is None:
        idx = rng.choice(n_samples, 2 * n, replace=n_samples < 2 * n)
        return list(idx[:n]), list(idx[n:])
    pos, neg = split
    pi = rng.choice(pos, n, replace=len(pos) < n)
    ni = rng.choice(neg, n, replace=len(neg) < n)
    return list(pi), list(ni)


def sample_context_ids(
    rng: np.random.Generator,
    samples: list[Sample],
    n: int,
    mode: str = "keyword",
    keyword: str | list[str] = DEFAULT_CONTEXT_KEYWORD,
    chexbert_labels: dict[str, np.ndarray] | None = None,
) -> tuple[list[int], list[int]]:
    """Split and draw in one call, for one-shot callers."""
    split = context_index_split(samples, mode, keyword, chexbert_labels)
    return draw_context_ids(rng, split, len(samples), n)


def group_study_two_views(
    samples: list[Sample], rng: np.random.Generator | None = None
) -> list[Sample]:
    """MIMIC study-grouped two-view sampling: pool image paths per
    study_id; a sample with 2 pooled paths uses both, >2 keeps its own
    plus one random pooled path, 1 duplicates itself."""
    rng = rng or np.random.default_rng(0)
    pooled: dict[str, list[str]] = {}
    for s in samples:
        if s.study_id is not None:
            pooled.setdefault(s.study_id, []).extend(s.image_paths)
    out = []
    for s in samples:
        group = pooled.get(s.study_id or "", s.image_paths)
        if len(group) == 2:
            paths = list(group)
        elif len(group) > 2:
            paths = s.image_paths + [group[int(rng.integers(len(group)))]]
        else:
            paths = s.image_paths + s.image_paths
        out.append(dataclasses.replace(s, image_paths=paths[:2]))
    return out


class MRGBatcher:
    """Host-side batch assembly with fixed shapes.

    ``image_loader(sample) -> (V, H, W, 3) float32`` is injected so that
    tests can substitute synthetic pixels for disk reads. A thread pool of
    ``num_workers`` loads the views of a batch (PIL decoding releases the
    GIL); ``close`` shuts it down. With ``n_context > 0`` each batch also
    holds ``context_images`` (B, 2 n_context, H, W, 3): the first view of
    ``n_context`` positive, then ``n_context`` negative samples of the
    batcher's own split, drawn per study after the batch's order.
    ``extra_fn(sample) -> {name: array}``, where given, adds per-sample side
    inputs (MAC-RRG's agent embeddings, the LM recipe's token ids), each
    stacked over the batch under its name.
    """

    def __init__(
        self,
        samples: list[Sample],
        tokenizer: WordTokenizer,
        image_loader,
        batch_size: int,
        max_len: int = 100,
        num_views: int = 2,
        prompt_before: str = "<bos> human : generate a comprehensive report",
        prompt_after: str = "assistant :",
        n_context: int = 0,
        context_mode: str = "keyword",
        context_keyword: str | list[str] = DEFAULT_CONTEXT_KEYWORD,
        chexbert_labels: dict | None = None,
        num_workers: int = 8,
        seed: int = 0,
        regroup_views: bool = False,
        extra_fn=None,
    ):
        self.samples = samples
        self.extra_fn = extra_fn
        self.n_context = n_context
        # the O(dataset) split (the rule labeler in chexbert mode), once
        self._context_split = (
            context_index_split(samples, context_mode, context_keyword,
                                chexbert_labels)
            if n_context > 0 else None
        )
        self.tok = tokenizer
        self.image_loader = image_loader
        self.batch_size = batch_size
        self.max_len = max_len
        self.num_views = num_views
        # MIMIC two-view pooling re-samples the extra view per epoch.
        self.regroup_views = regroup_views
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._pool = None
        if num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self.before_ids = np.asarray(
            tokenizer.encode(prompt_before.replace("<bos>", ""), add_bos=True)
        )
        self.after_ids = np.asarray(tokenizer.encode(prompt_after))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _map(self, fn, items) -> list:
        if self._pool is not None:
            return list(self._pool.map(fn, items))
        return [fn(x) for x in items]

    def _views(self, sample: Sample) -> np.ndarray:
        imgs = self.image_loader(sample)  # (V', H, W, 3)
        v = imgs.shape[0]
        if v < self.num_views:  # pad by repeating the first view
            reps = [imgs] + [imgs[:1]] * (self.num_views - v)
            imgs = np.concatenate(reps, axis=0)
        return imgs[: self.num_views]

    def _encode_report(self, report: str):
        ids = self.tok.encode(report, max_len=self.max_len - 1, add_eos=True)
        return self.tok.pad(ids, self.max_len)

    def batches(self, shuffle: bool = True, drop_last: bool = True,
                epoch: int | None = None) -> Iterator[dict]:
        """With ``epoch``, ordering and sampling are a function of
        (seed, epoch) alone, so a resumed run sees the same batches."""
        rng = (
            np.random.default_rng((self.seed, epoch))
            if epoch is not None
            else self.rng
        )
        samples = self.samples
        if self.regroup_views:
            samples = group_study_two_views(samples, rng)
        order = np.arange(len(samples))
        if shuffle:
            rng.shuffle(order)
        bs = self.batch_size
        end = len(order) - (len(order) % bs if drop_last else 0)
        for i in range(0, end, bs):
            chunk = [samples[j] for j in order[i : i + bs]]
            if len(chunk) < bs:
                chunk = chunk + [chunk[-1]] * (bs - len(chunk))
            images = np.stack(self._map(self._views, chunk))
            tgt, msk = zip(*(self._encode_report(s.report) for s in chunk))
            batch = dict(
                images=images.astype(np.float32),
                before_ids=np.tile(self.before_ids, (bs, 1)),
                after_ids=np.tile(self.after_ids, (bs, 1)),
                target_ids=np.asarray(tgt, np.int32),
                target_mask=np.asarray(msk, np.int32),
                ids=[s.id for s in chunk],
                reports=[s.report for s in chunk],
            )
            if self.n_context > 0:
                # the draws in the JAX order: per study, positives first
                ids = []
                for _ in chunk:
                    pi, ni = draw_context_ids(rng, self._context_split,
                                              len(self.samples),
                                              self.n_context)
                    ids += pi + ni
                ctx = self._map(lambda j: self._views(self.samples[j])[0],
                                ids)
                batch["context_images"] = np.stack(ctx).reshape(
                    bs, 2 * self.n_context, *ctx[0].shape).astype(np.float32)
            if self.extra_fn is not None:
                extras = [self.extra_fn(s) for s in chunk]
                for k in extras[0]:
                    batch[k] = np.stack([e[k] for e in extras])
            yield batch


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Assemble up to ``depth`` items ahead on a background thread.

    An exception in the producer is raised in the consumer. If the
    consumer stops early, the producer stops at its next item.
    """
    q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
            put((done, None))
        except BaseException as e:  # handed to the consumer, re-raised there
            put((done, e))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is done:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)


def disk_image_loader(base_dir: str, input_size: int,
                      fast_decode: bool = True):
    """Scaled JPEG/PNG decode + ``host_preprocess`` of every view."""

    def load(sample: Sample) -> np.ndarray:
        views = []
        for p in sample.image_paths:
            arr = decode_scaled(
                os.path.join(base_dir, p), input_size, fast=fast_decode)
            views.append(host_preprocess(arr, input_size))
        return np.stack(views)

    return load


def synthetic_annotations(
    n_train: int = 32, n_val: int = 8, n_test: int = 8, seed: int = 0
) -> dict[str, list[Sample]]:
    """Synthetic X-ray-like dataset for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    phrases = [
        "the lungs are clear", "no acute cardiopulmonary abnormality",
        "there is a small left pleural effusion",
        "heart size is normal", "no focal consolidation",
        "mild cardiomegaly is present", "no pneumothorax",
        "degenerative changes of the spine",
    ]

    def make(i):
        k = rng.integers(2, 5)
        picked = rng.choice(phrases, k, replace=False)
        report = " . ".join(picked) + " ."
        draft = " . ".join(picked[: max(int(k) - 1, 1)]) + " ."
        return Sample(
            f"s{i}", [f"img_{i}_0.png", f"img_{i}_1.png"], report,
            draft=draft,
        )

    return {
        "train": [make(i) for i in range(n_train)],
        "val": [make(10_000 + i) for i in range(n_val)],
        "test": [make(20_000 + i) for i in range(n_test)],
    }


def synthetic_image_loader(size: int = 64, views: int = 2):
    """Gaussian pixels seeded per sample.

    As in the JAX package, the seed is Python's ``hash(sample.id)``, which
    changes between processes (string hashing is randomised): two
    processes see different pixels for one sample, while the two packages
    see the same pixels within one process (ROADMAP.md, section 3).
    """

    def load(sample: Sample) -> np.ndarray:
        seed = abs(hash(sample.id)) % (2**32)
        rng = np.random.default_rng(seed)
        return rng.standard_normal((views, size, size, 3)).astype(np.float32)

    return load


# Learnable synthetic corpus: reports generated from a label grammar and
# images rendered from the same labels, so that image -> report (and image
# -> CheXpert labels) carries real signal without real data. Each finding
# has a distinct visual mark and a fixed positive/negative sentence; the
# report is a function of the 6-bit label vector (64 distinct reports).
LEARNABLE_FINDINGS = [
    ("cardiomegaly", "mild cardiomegaly is present",
     "heart size is normal"),
    ("left_effusion", "there is a small left pleural effusion",
     "no left pleural effusion"),
    ("right_effusion", "there is a small right pleural effusion",
     "no right pleural effusion"),
    ("pneumothorax", "there is a left apical pneumothorax",
     "no pneumothorax is seen"),
    ("consolidation", "focal consolidation in the right lung",
     "no focal consolidation"),
    ("spine", "degenerative changes of the spine",
     "the spine is unremarkable"),
]


def learnable_report(bits: int) -> str:
    parts = [pos if (bits >> k) & 1 else neg
             for k, (_, pos, neg) in enumerate(LEARNABLE_FINDINGS)]
    return " . ".join(parts) + " ."


def learnable_synthetic_annotations(
    n_train: int = 512, n_val: int = 64, n_test: int = 64, seed: int = 0,
    holdout: int = 0,
) -> dict[str, list[Sample]]:
    """Label-grammar corpus; the 6-bit label vector rides in the id.

    ``holdout > 0`` reserves that many of the 64 finding combinations for
    val/test only (every sentence is seen in training, the held-out
    combinations never are).
    """
    rng = np.random.default_rng(seed)
    n_f = len(LEARNABLE_FINDINGS)
    all_bits = np.arange(2**n_f)
    if holdout:
        held_set = {int(b) for b in rng.choice(all_bits, size=holdout,
                                               replace=False)}
        train_bits = np.asarray([b for b in all_bits
                                 if int(b) not in held_set])
        eval_bits = np.asarray(sorted(held_set))
    else:
        train_bits = eval_bits = all_bits

    def make(i, pool):
        bits = int(pool[rng.integers(0, len(pool))])
        report = learnable_report(bits)
        drop = rng.integers(0, n_f)
        draft = " . ".join(
            s for k, s in enumerate(report.rstrip(" .").split(" . "))
            if k != drop
        ) + " ."
        return Sample(f"ls{i}_{bits}", [f"v0_{i}.png", f"v1_{i}.png"],
                      report, draft=draft)

    return {
        "train": [make(i, train_bits) for i in range(n_train)],
        "val": [make(10_000 + i, eval_bits) for i in range(n_val)],
        "test": [make(20_000 + i, eval_bits) for i in range(n_test)],
    }


def render_learnable_image(bits: int, size: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Chest-radiograph-like rendering of a 6-bit finding vector, (size,
    size, 3) in [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.full((size, size), 0.15, np.float32)

    def ellipse(cx, cy, rx, ry, value):
        img[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0] += value

    ellipse(0.30, 0.45, 0.18, 0.30, 0.35)  # lung fields
    ellipse(0.70, 0.45, 0.18, 0.30, 0.35)
    ellipse(0.52, 0.62, 0.22 if bits & 1 else 0.12, 0.16, -0.20)  # heart
    if (bits >> 1) & 1:  # left effusion: bright base, viewer right
        img[(yy > 0.62) & (xx > 0.58) & (xx < 0.90)] += 0.30
    if (bits >> 2) & 1:  # right effusion
        img[(yy > 0.62) & (xx > 0.10) & (xx < 0.42)] += 0.30
    if (bits >> 3) & 1:  # pneumothorax: dark apical rim
        img[(yy < 0.25) & (xx > 0.58) & (xx < 0.92)] *= 0.3
    if (bits >> 4) & 1:  # consolidation blob mid-right lung
        ellipse(0.30, 0.40, 0.07, 0.07, 0.45)
    if (bits >> 5) & 1:  # spine hardware: bright midline bar
        img[:, int(0.48 * size):int(0.52 * size)] += 0.35
    img += rng.standard_normal((size, size)).astype(np.float32) * 0.03
    img = np.clip(img, 0.0, 1.0)
    return np.repeat(img[:, :, None], 3, axis=2)


def learnable_image_loader(size: int = 224, views: int = 2):
    """The rendered views of a learnable sample, preprocessed. Seeded by
    ``hash(sample.id)`` as :func:`synthetic_image_loader` is."""

    def load(sample: Sample) -> np.ndarray:
        bits = int(sample.id.rsplit("_", 1)[1])
        rng = np.random.default_rng(abs(hash(sample.id)) % (2**32))
        return np.stack([
            host_preprocess(np.round(render_learnable_image(bits, size, rng)
                                     * 255).astype(np.uint8), size)
            for _ in range(views)
        ])

    return load


def mixup_cutmix(
    rng: np.random.Generator,
    images: np.ndarray,
    labels: np.ndarray,
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    prob: float = 1.0,
    switch_prob: float = 0.5,
):
    """Batch mixup/cutmix (timm semantics, SwinCheX ``data/build.py``) over
    channels-last images (B, ..., H, W, C): returns (mixed images, soft
    labels). Cutmix pastes a box of half-sides ``rh // 2``, ``rw // 2``
    clipped to the image, and ``lam`` is recomputed from the clipped box.
    Labels may be multi-hot."""
    b = images.shape[0]
    labels = labels.astype(np.float32)
    if rng.random() > prob:
        return images, labels
    perm = rng.permutation(b)
    if rng.random() < switch_prob and cutmix_alpha > 0:
        lam = float(rng.beta(cutmix_alpha, cutmix_alpha))
        h, w = images.shape[-3], images.shape[-2]
        rh, rw = int(h * np.sqrt(1 - lam)), int(w * np.sqrt(1 - lam))
        cy, cx = int(rng.integers(h)), int(rng.integers(w))
        y0, y1 = max(cy - rh // 2, 0), min(cy + rh // 2, h)
        x0, x1 = max(cx - rw // 2, 0), min(cx + rw // 2, w)
        mixed = images.copy()
        mixed[..., y0:y1, x0:x1, :] = images[perm][..., y0:y1, x0:x1, :]
        lam = 1.0 - ((y1 - y0) * (x1 - x0) / (h * w))
    else:
        lam = (float(rng.beta(mixup_alpha, mixup_alpha)) if mixup_alpha > 0
               else 1.0)
        mixed = lam * images + (1.0 - lam) * images[perm]
    soft = lam * labels + (1.0 - lam) * labels[perm]
    return mixed.astype(images.dtype), soft


def zip_image_loader(zip_path: str, input_size: int,
                     fast_decode: bool = True):
    """Images read straight out of a zip archive (the JAX package's
    ``zip_image_loader``, SwinCheX's cached image folder): a ``zipfile``
    handle a thread, each of a sample's image paths decoded by
    ``decode_scaled`` and normalised by ``host_preprocess`` into float32
    ``(V, S, S, 3)``. ``load.close()`` releases every handle."""
    import io
    import zipfile

    local = threading.local()
    handles: list[zipfile.ZipFile] = []
    lock = threading.Lock()

    def handle() -> zipfile.ZipFile:
        if not hasattr(local, "zf"):
            local.zf = zipfile.ZipFile(zip_path)
            with lock:
                handles.append(local.zf)
        return local.zf

    def load(sample: Sample) -> np.ndarray:
        views = []
        for p in sample.image_paths:
            with handle().open(p) as f:
                arr = decode_scaled(io.BytesIO(f.read()), input_size,
                                    fast=fast_decode)
            views.append(host_preprocess(arr, input_size))
        return np.stack(views)

    def close():
        with lock:
            for zf in handles:
                zf.close()
            handles.clear()

    load.close = close
    return load
