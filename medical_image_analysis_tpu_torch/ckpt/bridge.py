"""Pretrain -> downstream weight bridges (stage chaining) over the port's own
artifacts.

Counterpart of ``medical_image_analysis_tpu/ckpt/bridge.py``. The reference
chains its stages by checkpoint surgery at load time:

- AR stage 1 -> CLIP stage 2 / SFT stage 3: each 1-direction mixer tensor
  copied into the 4 direction slots, the decoder dropped, loaded
  ``strict=False`` so that downstream-only parameters keep their init;
- HD MAE pretrain -> DP / RG finetunes: the encoder subtree.

The artifacts are the port's own (``ckpt/checkpoint.py``): a full train
state (``save_train_state``) or a trainable-only delta (``save_delta``),
``torch.save`` of tensors named by flax path; or the JAX package's msgpack
ones, a train state or a delta (a pretraining run on the TPU feeding a
fine-tune here), renamed and put in the port's layouts by
``checkpoint.from_jax_tree``. Trees are
nested dicts of tensors keyed by the flax path's parts, in the port's
layouts (so a tower's overlay fits the port's tower of the same names).
Set ``model.vision_init=<state_epoch*.pt>`` on ``fit_clip``, ``fit_mrg``
or ``fit_classify`` (``vit``, ``vssm``).
"""

from __future__ import annotations

import torch

# Mixer parameters with a leading direction axis (K=1 in the AR pretrain
# model, K=4 in the ARM's bimamba v3); in_proj and out_proj are shared
# across directions in both.
_K_LEADING = {
    "A_log", "D", "conv_b", "conv_w", "dt_bias", "dt_proj_w", "x_proj_w",
}


def nest(flat: dict) -> dict:
    """``{"a/b/c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    tree: dict = {}
    for name, value in flat.items():
        *parents, leaf = name.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of :func:`nest`, names under ``prefix``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out


def load_pretrain_params(path: str) -> dict:
    """The model's parameter tree from a recipe artifact: a full train
    state (trainable and frozen tensors together) or a delta, the port's
    or the JAX package's; the structure tells them apart. A JAX tree loses
    its flax ``{"params": ...}`` levels, as the JAX function unwraps them,
    and a JAX delta's frozen (empty) leaves are dropped."""
    from .checkpoint import from_jax_tree, is_torch_file, read_jax_file

    if not is_torch_file(path):
        obj = read_jax_file(path)
        if "state" in obj:  # save_train_state blob
            tree = obj["state"]["params"]
        elif "model" in obj:  # save_delta blob
            tree = obj["model"]
        else:
            tree = obj
        return nest({n: t for n, t in from_jax_tree(tree).items()
                     if t.numel()})
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if "state" in obj:  # save_train_state blob
        flat = {**obj["state"].get("frozen", {}), **obj["state"]["params"]}
    elif "model" in obj:  # save_delta blob
        flat = obj["model"]
    else:
        flat = obj
    return nest(flat)


def ar_encoder_to_arm(ar: dict, k: int = 4) -> dict:
    """VisionMambaAR encoder -> ARM overlay: tile the K=1 mixer tensors to
    ``k`` directions (the reference copies the same pretrain tensor into
    every slot), keep patch_embed and the layers' norms, drop the AR
    decoder and skip-fusion heads. ARM-only parameters (cls_token,
    pos_embed, norm_f) keep their downstream init."""
    out = {"patch_embed": ar["patch_embed"]}
    for name, sub in ar.items():
        if not name.startswith("layers_"):
            continue
        mixer = {}
        for pn, v in sub["mixer"].items():
            if isinstance(v, dict):  # in_proj/out_proj: shared across dirs
                mixer[pn] = v
                continue
            if pn in _K_LEADING:
                if v.shape[0] != 1:
                    raise ValueError(
                        f"{name}/mixer/{pn}: expected a 1-direction "
                        f"pretrain tensor, got leading dim {v.shape[0]}"
                    )
                v = v.repeat(k, *([1] * (v.dim() - 1)))
            mixer[pn] = v
        out[name] = {"mixer": mixer, "norm": sub["norm"]}
    return out


def mae_encoder_to_vit(mae: dict) -> dict:
    """MAE -> ViT overlay: encoder blocks, cls_token and patch_embed, with
    encoder_norm as norm; the decoder dropped."""
    out = {
        k: v
        for k, v in mae.items()
        if k.startswith("block") or k in ("cls_token", "patch_embed")
    }
    out["norm"] = mae["encoder_norm"]
    return out


def resolve_vision_overlay(src: dict, family: str) -> dict:
    """Find or derive the ``family`` tower overlay inside a recipe
    artifact: an AR or MAE pretrain tree, a CLIP stage-2 state, an SFT
    state, a classifier state, or a bare tower tree."""
    if family == "arm":
        if "visual_encoder" in src:  # CLIP stage-2 state (4-dir already)
            return src["visual_encoder"]
        if "arm" in src.get("vision", {}):  # an SFT state
            return src["vision"]["arm"]
        if "enc2dec" in src or "ar_token" in src:  # AR stage-1 pretrain
            return ar_encoder_to_arm(src)
        if "layers_0" in src and "norm_f" in src:  # bare ARM tree
            return src
    elif family == "vit":
        if "encoder_norm" in src:  # MAE pretrain state
            return mae_encoder_to_vit(src)
        if "vit" in src.get("vision", {}):
            return src["vision"]["vit"]
        if "encoder" in src:  # DPClassifier state
            return src["encoder"]
        if "block0" in src and "norm" in src:  # bare ViT tree
            return src
    elif family == "vssm":
        if "backbone" in src:  # VSSMClassifier state
            return src["backbone"]
        if "vssm" in src.get("vision", {}):
            return src["vision"]["vssm"]
        if "layers_0" in src or "patch_embed" in src:  # bare VSSM tree
            return src
    raise ValueError(
        f"could not locate a '{family}' tower in the artifact "
        f"(top-level keys: {sorted(src)[:12]})"
    )


def graft(params: dict, path: tuple[str, ...], overlay: dict) -> dict:
    """Return ``params`` with ``overlay`` merged into the subtree at
    ``path``. Every overlay leaf must exist in the target with the same
    shape (``KeyError``, ``ValueError``); target-only keys keep their
    values (strict=False semantics). Leaves take the target's dtype."""

    def merge(dst, src, where):
        out = dict(dst)
        for k, v in src.items():
            if k not in dst:
                raise KeyError(f"{where}/{k} not in the target model")
            if isinstance(v, dict):
                out[k] = merge(dst[k], v, f"{where}/{k}")
            else:
                tgt = tuple(dst[k].shape)
                if tgt != tuple(v.shape):
                    raise ValueError(
                        f"{where}/{k}: shape {tuple(v.shape)} does not "
                        f"match target {tgt}"
                    )
                out[k] = torch.as_tensor(v).to(dst[k].dtype)
        return out

    def descend(node, rest):
        if not rest:
            return merge(node, overlay, "/".join(path) or ".")
        head = rest[0]
        if head not in node:
            raise KeyError(f"subtree '{head}' not in params")
        return {**node, head: descend(node[head], rest[1:])}

    return descend(params, list(path))


@torch.no_grad()
def apply_vision_init(named: dict[str, torch.Tensor], artifact_path: str,
                      family: str, subtree: tuple[str, ...]) -> list[str]:
    """The recipes' hook: load the artifact, resolve the ``family`` tower's
    overlay, graft it at ``subtree`` and copy it into ``named`` (a model's
    parameters by flax path, ``ckpt.from_jax.flax_named_parameters``) in
    place. Returns the names written."""
    src = load_pretrain_params(artifact_path)
    overlay = resolve_vision_overlay(src, family)
    merged = flatten(graft(nest(named), subtree, overlay))
    written = sorted(flatten(overlay, "/".join(subtree)))
    for name in written:
        named[name].copy_(merged[name])
    kept = ", ".join(sorted(overlay)[:6])
    print(f"[vision_init] grafted {family} tower from {artifact_path} "
          f"at {'/'.join(subtree)} ({kept}, ...)")
    return written
