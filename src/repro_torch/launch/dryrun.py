"""Dry-run of every (arch x shape x mesh) cell: per-rank bytes, derived
roofline terms and, with ``--measure``, a few layers timed on the card.

The counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's step on 256 or 512 fake host devices and reads XLA's
memory and cost analyses.  The port has no compiler to ask; for each
runnable cell (the skip rules of ``configs.shape_applicable``) it

1. builds the production mesh (``(16, 16)``, or ``(2, 16, 16)``
   multi-pod) on ``meta`` devices, so nothing is allocated;
2. derives each rank's parameter, optimizer-state, cache and input bytes
   from the placements (``models.model.param_shardings``,
   ``serve.kvcache.cache_shardings``, ``launch.inputs.input_shardings``;
   the optimizer state follows the parameters' placements, as the
   reference's ``_state_shardings`` lays it out);
3. derives the step's FLOPs (the layers the port runs: a training step is
   a forward, a recompute and a backward), the collective bytes the
   port's mesh program hands the mesh (:func:`collective_bytes_derived`:
   the data-parallel float32 gradient ``psum``, the MoE ``psum``/``pmean``
   over ``model``), and the three roofline terms at the H100's rates
   (``launch/roofline.py``);
4. with ``--measure``, runs the cell's step on the card at one layer
   period with the batch cut (:func:`measure_cell`): the peak of
   ``torch.cuda.max_memory_allocated`` and the device time by kernel kind
   from ``torch.profiler``.

Every record says which of its numbers are ``derived`` and which are
``measured``.  ``model_flops``, ``pick_grad_accum``, ``_layer_period``,
``_opt_bits`` and ``enumerate_cells`` are the reference's, line for line.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun              # every cell, derived
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k --measure                                   # on the card

Records go to ``build/launch/dryrun.json`` (``--out``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import SHAPES, all_archs, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.compat import P, Placement
from repro_torch.launch import roofline as R
from repro_torch.launch.inputs import input_shardings, train_input_shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import axis_size, dp_axes
from repro_torch.models.model import (
    _leaves, active_param_count, param_count, param_shape_structs, param_shardings,
)
from repro_torch.serve.kvcache import cache_shapes, cache_shardings
from repro_torch.train.optimizer import BLOCK

RESULTS = pathlib.Path("build/launch")


def _opt_bits(cfg: ModelConfig) -> int:
    return 8 if param_count(cfg) > 50e9 else 32


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D train, 2*N_active*D inference."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def _layer_period(cfg: ModelConfig) -> int:
    """The homogeneous repeat unit (hybrid: a group of `every` layers)."""
    return cfg.shared_attn_every if cfg.family == "hybrid" else 1


def pick_grad_accum(cfg: ModelConfig, shape: ShapeConfig, chips_dp: int) -> int:
    """Grad accumulation so each microbatch holds <=8k tokens per dp shard
    (bounds the scan-carry activation memory; see EXPERIMENTS.md)."""
    per_shard_tokens = shape.global_batch * shape.seq_len // chips_dp
    accum = max(1, per_shard_tokens // 8192)
    while shape.global_batch % (accum * chips_dp) and accum > 1:
        accum //= 2
    return accum


def enumerate_cells():
    cells = []
    for arch in all_archs():
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            cells.append((arch, sname, ok, why))
    return cells


# ---------------------------------------------------------------------------
# derived: per-rank bytes from the placements on a meta mesh
# ---------------------------------------------------------------------------
def _block_elems(place: Placement, shape) -> int:
    """Elements of one rank's block (a dim that does not split evenly is
    counted at its largest block)."""
    n = 1
    for i, d in enumerate(shape):
        entry = place.spec[i] if i < len(place.spec) else None
        names = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        n *= -(-d // math.prod(place.mesh.shape[a] for a in names))
    return n


def _state_shardings(param_places: dict, mesh, bits: int) -> dict:
    """The optimizer state's placements, as the reference's
    ``_state_shardings``: the step replicated; each leaf's moments on the
    parameter's placement, or in 8-bit mode the int8 codes on it and the
    block scales without its (blocked) last-dim partitioning."""
    def one(place: Placement):
        if bits != 8:
            return {"m": place, "v": place}
        spec = tuple(place.spec)
        scale = Placement(mesh, P(*spec[:-1], None)) if spec else Placement(mesh, P())
        return {"m": {"q": place, "scale": scale}, "v": {"q": place, "scale": scale}}

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else one(v) for k, v in tree.items()}

    return {"step": Placement(mesh, P()), "moments": walk(param_places)}


def rank_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Each rank's bytes of the cell's state under the reference's
    placements (derived from shapes; nothing is allocated): ``params``,
    ``opt_state`` (train cells: the moments at ``_opt_bits``), ``cache``
    (decode cells) and ``inputs``."""
    structs = dict(_leaves(param_shape_structs(cfg)))
    place_tree = param_shardings(cfg, mesh)
    places = dict(_leaves(place_tree))
    out = {"params": sum(_block_elems(places[k], s.shape) * s.dtype.itemsize for k, s in structs.items())}
    if shape.kind == "train":
        bits = _opt_bits(cfg)
        state = dict(_leaves(_state_shardings(place_tree, mesh, bits)["moments"]))
        opt = 4  # the step counter
        for k, s in structs.items():
            if bits == 8:
                padded = tuple(s.shape[:-1]) + (-(-s.shape[-1] // BLOCK) * BLOCK,)
                blocks = tuple(s.shape[:-1]) + (padded[-1] // BLOCK,)
                opt += 2 * (_block_elems(state[k + ("m", "q")], padded)
                            + 4 * _block_elems(state[k + ("m", "scale")], blocks))
            else:
                opt += 2 * 4 * _block_elems(state[k + ("m",)], s.shape)
        out["opt_state"] = opt
    if shape.kind == "decode":
        cs = cache_shapes(cfg, shape.global_batch, shape.seq_len)
        cp = cache_shardings(cfg, shape.global_batch, shape.seq_len, mesh)
        out["cache"] = sum(_block_elems(cp[k], shp) * dt.itemsize for k, (shp, dt) in cs.items())
        out["inputs"] = _block_elems(Placement(mesh, P(dp_axes(mesh), None)), (shape.global_batch, 1)) * 4
    else:
        ip = input_shardings(cfg, shape, mesh)
        out["inputs"] = sum(_block_elems(ip[k], shp) * dt.itemsize
                            for k, (shp, dt) in train_input_shapes(cfg, shape).items())
    return out


# ---------------------------------------------------------------------------
# derived: FLOPs and the port's collectives
# ---------------------------------------------------------------------------
def _attn_dims(cfg: ModelConfig) -> tuple:
    if cfg.attn == "mla":
        return cfg.num_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    return cfg.num_heads, cfg.head_dim, cfg.head_dim


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers


def _mamba_layers(cfg: ModelConfig) -> int:
    return cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0


def step_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The FLOPs of the step the port runs (global; derived): the matmuls
    at 2 FLOPs an active parameter a token (:func:`model_flops`'s count),
    the attention scores and values (causal: half the square; decode: the
    whole context), and the SSD's intra-chunk product and chunk states.  A
    training step is a forward, a recompute (each unit is checkpointed)
    and a backward of twice the forward: four forwards."""
    B, S = shape.global_batch, shape.seq_len
    H, dqk, dv = _attn_dims(cfg)
    if shape.kind == "decode":
        tokens, attn = B, 2.0 * B * S * H * (dqk + dv)
    else:
        tokens = B * S
        attn = 2.0 * B * S * S * H * (dqk + dv) * (0.5 if cfg.causal else 1.0)
    ssd = 0.0
    if cfg.ssm_state:
        Hs, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        if shape.kind == "decode":
            ssd = 4.0 * B * Hs * Pd * N
        else:
            Q = min(cfg.ssm_chunk, S)
            ssd = 2.0 * B * S * Q * Hs * (N + Pd) + 4.0 * B * S * Hs * Pd * N
    fwd = 2.0 * active_param_count(cfg) * tokens + _attn_layers(cfg) * attn + _mamba_layers(cfg) * ssd
    return 4.0 * fwd if shape.kind == "train" else fwd


def collective_bytes_derived(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict,
                             grad_accum: int = 1) -> dict:
    """The operand bytes, summed over the ranks, that the port's mesh
    program hands each collective kind in one step (the counts
    ``ShardMesh.collective_bytes`` takes; ``tests/test_torch_launch.py``
    holds this formula to them on CPU meshes):

    * each MoE layer's ``psum`` over ``model`` of a rank's partial output
      [T_local, d] in bfloat16 and ``pmean`` of its float32 aux, once in
      the forward and once more in a training step's recompute;
    * a training step's float32 gradient ``psum`` over the data axes, one
      whole gradient a rank (the port holds whole weights), where there
      is more than one data shard."""
    ranks = math.prod(mesh_shape.values())
    tp = mesh_shape.get("model", 1)
    dp = ranks // tp
    out = dict.fromkeys(("all-reduce", "all-gather", "all-to-all", "collective-permute"), 0)
    B = shape.global_batch // (grad_accum if shape.kind == "train" else 1)
    tokens = B * (1 if shape.kind == "decode" else shape.seq_len)
    if cfg.family == "moe" and (tp > 1 or shape.kind != "train"):
        per_layer = ranks * (tokens // dp * cfg.d_model * 2 + 4)
        calls = grad_accum * 2 if shape.kind == "train" else 1
        out["all-reduce"] += cfg.num_layers * per_layer * calls
    if shape.kind == "train" and dp > 1:
        out["all-reduce"] += ranks * 4 * param_count(cfg)
    return out


def derive_cell(arch: str, shape_name: str, multi_pod: bool, cfg: ModelConfig | None = None,
                grad_accum: int | None = None) -> dict:
    """The cell's derived record on the production mesh (``meta``
    devices)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod, devices=("meta",) * (512 if multi_pod else 256))
    chips = mesh.size
    dp_n = axis_size(mesh, dp_axes(mesh))
    if grad_accum is None:
        grad_accum = pick_grad_accum(cfg, shape, dp_n) if shape.kind == "train" else 1
    per_rank = rank_bytes(cfg, shape, mesh)
    flops = step_flops(cfg, shape) / chips
    coll = collective_bytes_derived(cfg, shape, mesh.shape, grad_accum)
    coll_dev = sum(coll.values()) / chips
    passes = 4 if shape.kind == "train" else 1
    # the least bytes a rank's step moves: its weights once a pass, its
    # optimizer state read and written, its cache and inputs read once
    touched = (per_rank["params"] * passes + 2 * per_rank.get("opt_state", 0)
               + per_rank.get("cache", 0) + per_rank["inputs"])
    roof = R.Roofline.from_counts(flops, touched, coll_dev, model_flops=model_flops(cfg, shape),
                                  chips=chips)
    return {
        "arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "grad_accum": grad_accum, "status": "ok",
        "derived": {
            "per_rank_bytes": per_rank,
            "step_flops": step_flops(cfg, shape),
            "collective_bytes_per_dev": {k: v / chips for k, v in coll.items()},
            "roofline": roof.as_dict(),
        },
    }


# ---------------------------------------------------------------------------
# measured: one layer period of the cell on the card
# ---------------------------------------------------------------------------
MEASURE_BATCH = {"train": 1, "prefill": 1, "decode": 8}


def measure_cell(arch: str, shape_name: str, *, device=None, periods: int = 1, batch: int | None = None,
                 cfg: ModelConfig | None = None, grad_accum: int = 1, seed: int = 0) -> dict:
    """Run the cell's step on ``device`` at ``periods`` layer periods, the
    batch cut to ``batch`` (``MEASURE_BATCH`` by kind, at most the
    shape's) at the shape's full length: a warm-up call, then one profiled.  Returns the measured
    ``{"layers", "batch", "peak_bytes", "wall_ms", "busy_ms",
    "device_ms_by_kind"}``."""
    from repro_torch.core.device import resolve_device
    from repro_torch.launch.inputs import make_inputs
    from repro_torch.models.model import forward, init_params
    from repro_torch.serve.kvcache import init_cache
    from repro_torch.serve.serve_step import make_decode_step
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainConfig, make_train_state, make_train_step

    device = resolve_device(device)
    full = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    cfg = dataclasses.replace(full, num_layers=periods * _layer_period(full))
    B = batch or min(MEASURE_BATCH[shape.kind], shape.global_batch)
    cut = dataclasses.replace(shape, global_batch=B)
    params = init_params(cfg, seed, device)
    R.reset_peak(device)
    if shape.kind == "train":
        tcfg = TrainConfig(opt=OptConfig(state_bits=_opt_bits(full)), grad_accum=grad_accum)
        state, step = make_train_state(params, tcfg), make_train_step(cfg, tcfg)
        inputs = make_inputs(cfg, cut, seed=seed, device=device)

        def run():
            step(params, state, inputs)
    elif shape.kind == "prefill":
        inputs = make_inputs(cfg, cut, seed=seed, device=device)

        def run():
            with torch.inference_mode():
                forward(params, inputs, cfg, last_only=True)
    else:
        serve_cfg = dataclasses.replace(cfg, frontend="none")
        cache = init_cache(serve_cfg, B, shape.seq_len, device)
        cache["pos"].fill_(shape.seq_len - 1)  # attend over the whole context
        step = make_decode_step(serve_cfg)
        tok = torch.zeros((B, 1), dtype=torch.int64, device=device)

        def run():
            with torch.inference_mode():
                cache["pos"].fill_(shape.seq_len - 1)
                step(params, cache, tok)
    run()
    prof = R.profile_device(run, device)
    return {"layers": cfg.num_layers, "batch": B, "peak_bytes": R.peak_bytes(device), **prof}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--measure", action="store_true",
                    help="also run each cell at one layer period on the card")
    ap.add_argument("--device", default=None, help="torch device for --measure (default: the card)")
    ap.add_argument("--out", default=str(RESULTS / "dryrun.json"))
    args = ap.parse_args(argv)

    cells = enumerate_cells()
    if args.list:
        for arch, sname, ok, why in cells:
            print(f"{arch:20s} {sname:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return []

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    records = []
    for arch, sname, ok, why in cells:
        if (args.arch and arch != args.arch) or (args.shape and sname != args.shape):
            continue
        if not ok:
            print(f"SKIP {arch} {sname}: {why}")
            continue
        for mp in meshes:
            t0 = time.time()
            try:
                rec = derive_cell(arch, sname, mp)
                if args.measure and not mp:
                    rec["measured"] = measure_cell(arch, sname, device=args.device)
            except Exception as e:  # noqa: BLE001 - a cell's failure is its record
                traceback.print_exc()
                rec = {"arch": arch, "shape": sname, "mesh": "2x16x16" if mp else "16x16",
                       "status": f"error: {type(e).__name__}: {str(e)[:500]}"}
            rec["elapsed_s"] = time.time() - t0
            records.append(rec)
            roof = rec.get("derived", {}).get("roofline", {})
            print(f"{arch:20s} {sname:12s} {rec.get('mesh')}: {rec['status']}"
                  + (f", dominant {roof['dominant']}, bound {roof['step_time_bound_s']:.4g} s" if roof else ""),
                  flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    return records


if __name__ == "__main__":
    main()
