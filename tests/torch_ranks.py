"""Several processes of the port on the CPU, joined by a gloo group.

``spawn(fn, world, *args)`` starts ``world`` processes (the ``spawn``
start method: each imports only torch, the port and this module, never
JAX), binds a free port for their rendezvous, runs
``fn(rank, world, *args)`` in each and returns the ranks' results in rank
order. A rank that raises, exits or outlives ``timeout`` seconds fails the
call: every process is then killed, so a dead peer cannot hang the tier.
The functions run in the ranks live here, importable by name.
"""

from __future__ import annotations

import os
import queue
import socket
import tempfile
import traceback

import torch.multiprocessing as mp

TIMEOUT_S = 150.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args, out):
    try:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          WORLD_SIZE=str(world), RANK=str(rank),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        import torch

        torch.set_num_threads(1)
        from medical_image_analysis_tpu_torch.parallel.mesh import (
            init_distributed)

        init_distributed(backend="gloo", timeout_s=TIMEOUT_S)
        result = _plain(fn(rank, world, *args))
        out.put((rank, "ok", result))
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _plain(tree):
    """Tensors as numpy arrays (fp32 for bf16): a queue passes a tensor by
    a handle that dies with its process."""
    import torch

    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def spawn(fn, world: int, *args, timeout: float = TIMEOUT_S) -> list:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, out),
                         daemon=True) for r in range(world)]
    # one hash seed for every run: rank 0's synthetic images (seeded by
    # Python's hash of the sample ids) are then the one-process run's
    saved = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        for p in procs:
            p.start()
    finally:
        if saved is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = saved
    results: dict = {}
    try:
        while len(results) < world:
            try:
                rank, status, value = out.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))}"
                                   f" gave no result in {timeout} s") from None
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


# --------------------------------------------------------------------------
# Functions run in the ranks
# --------------------------------------------------------------------------


def fit_runs(rank, world, runs):
    """``loop.fit`` on the CPU of each ``(name, preset, sets)`` of ``runs``
    in turn (``preset`` a YAML path, or a config dict), in this rank; rank 0
    returns {name: the steps' log records, the scores, the last train
    state's tensors}, the others None."""
    import json

    import torch

    from medical_image_analysis_tpu_torch.configs.config import (
        load_config,
        make_config,
    )
    from medical_image_analysis_tpu_torch.train import loop

    out = {}
    for name, preset, sets in runs:
        torch.manual_seed(0)
        cfg = (make_config(preset, list(sets)) if isinstance(preset, dict)
               else load_config(preset, list(sets)))
        scores = loop.fit(cfg, "cpu")
        if rank != 0:
            continue
        with open(os.path.join(cfg.train.save_dir, "log.txt")) as f:
            records = [json.loads(line) for line in f]
        states = sorted(n for n in os.listdir(cfg.train.save_dir)
                        if n.startswith("state_epoch"))
        state = torch.load(os.path.join(cfg.train.save_dir, states[-1]),
                           weights_only=True)["state"] if states else None
        out[name] = {"records": records, "scores": scores, "state": state}
    return out if rank == 0 else None


def tmpdir() -> str:
    return tempfile.mkdtemp(prefix="mia_ranks_")


# the dryrun_multichip model: an ARM tower and an fp32 LLM, every tensor
# trains (the LLM's kernels cut over the model axis, their moments ZeRO)
DRYRUN_LLM = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
                  hidden_dim=128)
DRYRUN_ARM = dict(patch_size=16, embed_dim=32, depth=1, d_state=4,
                  drop_path_rate=0.0)


def dryrun_model():
    import torch

    from medical_image_analysis_tpu_torch.models import llm, mrg

    return mrg.R2GenGPT(llm.LLMConfig(**DRYRUN_LLM, dtype=torch.float32),
                        chosen="arm",
                        vision_kwargs=dict(DRYRUN_ARM, img_size=32)).eval()


def sharded_steps(rank, world, params, batch, grid, steps, accum,
                  min_size=1 << 14, save_path=None, save_after=0,
                  restore_path=None):
    """``steps`` train steps of the dryrun model from the flax ``params``
    (every tensor trains: AdamW at 1e-4, clip 1) on the global numpy
    ``batch``, over a ``grid`` = (data, model) of the ranks (one process:
    no grid); with ``save_path``, ``save_full`` after step ``save_after``;
    with ``restore_path``, ``restore_full`` first. Returns each step's
    (loss, grad norm) and, on rank 0, the one-process state."""
    import torch

    from medical_image_analysis_tpu_torch.ckpt.checkpoint import (
        restore_full,
        save_full,
    )
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
        load_jax_params,
    )
    from medical_image_analysis_tpu_torch.parallel.mesh import (
        make_mesh,
        reset_traffic,
        shard_batch,
        traffic,
    )
    from medical_image_analysis_tpu_torch.parallel.tp import shard_llm
    from medical_image_analysis_tpu_torch.train import optim, train_state

    port = dryrun_model()
    load_jax_params(port, params)
    named = flax_named_parameters(port)
    state = train_state.TrainState(
        named, optim.make_adamw(named, lambda _count: 1e-4))
    mesh = make_mesh(*grid) if world > 1 else None
    if mesh is not None:
        cut = shard_llm(port.llm, mesh)
        train_state.shard_state(state, mesh,
                                {f"llm/{p}": how for p, how in cut.items()},
                                True, set(), min_size)
    if restore_path:
        restore_full(restore_path, state)
    step = train_state.make_train_step(lambda b: port(*b.values()), accum,
                                       mesh=mesh)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    local = shard_batch(mesh, tensors, accum)
    eval_loss = float(train_state.make_eval_step(
        lambda b: port(*b.values()), mesh)(shard_batch(mesh, tensors)))
    out = []
    reset_traffic()
    for i in range(steps):
        m = step(state, local)
        out.append((float(m["loss"]), float(m["grad_norm"])))
        if save_path and i == save_after:
            save_full(save_path, state)
    zero = 0 if state.plan is None else len(state.plan.zero)
    sd = state.state_dict()
    return {"metrics": out, "state": sd["params"] if rank == 0 else None,
            "zero_slices": zero, "traffic": dict(traffic),
            "eval_loss": eval_loss}


def tp_check(rank, world, task, inputs, gen_kw):
    """A tiny ``task`` model (R2GenGPT or EMRRG: an ARM and an fp32 GQA
    LLM, 4 heads on 2 KV heads) from a seed, cut over a (1, ``world``)
    grid: its loss, every parameter's gradient (gathered whole) and its
    beam tokens on the numpy ``inputs``."""
    import torch

    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.configs.config import (
        GenerateConfig,
        make_config,
    )
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.parallel.mesh import make_mesh
    from medical_image_analysis_tpu_torch.parallel.tp import (
        gather_tp,
        shard_llm,
    )
    from medical_image_analysis_tpu_torch.train import loop

    cfg = make_config({"model": {
        "task": task, "vision": "arm",
        "vision_kwargs": dict(patch_size=16, embed_dim=32, depth=1,
                              d_state=4, drop_path_rate=0.0),
        "llm_kwargs": dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                           hidden_dim=64, dtype="float32"),
        "task_kwargs": {"cross_every": 1} if task == "emrrg" else {}}},
        ["data.input_size=32"])
    model = loop.build_mrg_model(cfg, 64).eval()
    init_params(model, torch.Generator().manual_seed(3))
    mesh = make_mesh(1, world) if world > 1 else None
    cut = shard_llm(model.llm, mesh)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    loss = model(t["images"], t["before_ids"], t["after_ids"],
                 t["target_ids"], t["target_mask"])
    named = flax_named_parameters(model)
    grads = torch.autograd.grad(loss, list(named.values()))
    whole = {n: gather_tp(g, mesh, cut.get(n[len("llm/"):]))
             for n, g in zip(named, grads)}
    with torch.no_grad():
        tokens = model.generate(t["images"], t["before_ids"], t["after_ids"],
                                GenerateConfig(**gen_kw))
    return {"loss": loss.detach(), "grads": whole if rank == 0 else None,
            "tokens": tokens, "cut": sorted(cut)}


def sp_scan_rank(rank, world, cases):
    """``selective_scan_sp`` of each case (a dict of numpy inputs and
    ``softplus``) with L sharded over a (``world``, 1) grid: this rank's
    block of y."""
    import torch

    from medical_image_analysis_tpu_torch.parallel.mesh import make_mesh
    from medical_image_analysis_tpu_torch.parallel.sp_scan import (
        selective_scan_sp,
    )

    mesh = make_mesh(world, 1) if world > 1 else None
    out = []
    for case in cases:
        t = {k: torch.from_numpy(v) for k, v in case.items()
             if k != "softplus"}
        rows = t["u"].shape[1] // world
        sl = slice(rank * rows, (rank + 1) * rows)
        out.append(selective_scan_sp(
            t["u"][:, sl], t["delta"][:, sl], t["A"], t["B"][:, sl],
            t["C"][:, sl], t["D"], t["delta_bias"], case["softplus"], mesh))
    return out
