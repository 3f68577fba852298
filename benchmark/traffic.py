"""The one generator of training traffic: a step's batch from a cell's
``traffic`` parameters, the run's seed and the step's index.

Every draw is made on the device from a generator keyed by (seed, step),
so a step's batch is the same in every run of a seed, steps differ from
each other, and the reference is handed the very batches the program
took. Keys of ``traffic``:

- ``batch``: rows a step (images, or studies of ``views`` images);
- ``images``: ``{"size", "channels", "views"}``: normal pixels,
  channels-last, (B, H, W, C) or, with ``views``, (B, V, H, W, C);
- ``mask_noise``: ``{"patch"}``: MAE's masking noise (B, L), uniform,
  from ``SeedSequence([seed, step])`` as the program's own recipe draws
  it;
- ``prompt``: ``{"before", "after", "bos_id", "vocab"}``: the template's
  words as ids (a fixed hash of each word into the vocabulary), the same
  in every row;
- ``report``: ``{"max_len", "median", "sigma", "min", "vocab"}``: report
  lengths log-normal about ``median`` (a heavy right tail), cut to
  ``[min, max_len]``, ids uniform over the vocabulary, padded to
  ``max_len`` with a 0/1 mask.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from harness import derive


def _gen(device, seed, *tags):
    return torch.Generator(device).manual_seed(derive(seed, *tags))


def prompt_ids(words: str, vocab: int, bos_id: int | None = None) -> list:
    ids = [zlib.crc32(w.encode()) % vocab for w in words.split()]
    return ([bos_id] if bos_id is not None else []) + ids


def make_batch(traffic: dict, seed: int, step: int, device) -> dict:
    b = traffic["batch"]
    out = {}
    im = traffic.get("images")
    if im:
        shape = (b,) + ((im["views"],) if im.get("views") else ()) + (
            im["size"], im["size"], im.get("channels", 3))
        out["images"] = torch.randn(shape, generator=_gen(
            device, seed, "images", step), device=device)
    mn = traffic.get("mask_noise")
    if mn:
        n = (im["size"] // mn["patch"]) ** 2
        key = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
        out["mask_noise"] = torch.rand(
            b, n, generator=torch.Generator(device).manual_seed(key),
            device=device)
    pr = traffic.get("prompt")
    if pr:
        for part, bos in (("before", pr.get("bos_id")), ("after", None)):
            ids = prompt_ids(pr[part], pr["vocab"], bos)
            out[f"{part}_ids"] = torch.tensor(
                ids, device=device, dtype=torch.long).expand(b, -1)
    rp = traffic.get("report")
    if rp:
        g = _gen(device, seed, "report", step)
        z = torch.randn(b, generator=g, device=device)
        lens = torch.round(rp["median"] * torch.exp(rp["sigma"] * z))
        lens = lens.clamp(rp["min"], rp["max_len"])
        ids = torch.randint(0, rp["vocab"], (b, rp["max_len"]), generator=g,
                            device=device)
        pos = torch.arange(rp["max_len"], device=device)
        mask = (pos[None, :] < lens[:, None]).long()
        out["target_ids"] = ids * mask
        out["target_mask"] = mask
    return out
