"""Closed-loop training: the port's ``make_train_step`` (the train CLI's
default loss, KL divergence; Adam; ``--bf16``: bf16 convolutions under
autocast over f32 master weights, Adam state and BatchNorm statistics) on
batches the train CLI's ``to_device`` uploads each step, as its loader
hands them.

Traffic parameters (``traffic/<name>.json``): ``batch`` (clips a step),
``pool`` (clips held on the host, made from the seed; a step takes
``batch`` of them, the first three steps all different ones, later passes
in another seeded order), ``warm_steps`` (set-up steps after the three the
check follows), ``trace_steps``, ``lr``.

Set-up builds one train state and drives it through steps 1-3 with the
window's own call, keeping the first step's Adam moment (the first
gradient, as the optimizer got it) and the parameters after step 3; then
``warm_steps`` more; the window hands on the same state. After the window
the plain reference takes the same three steps from the same weights on
the same batches in f32, and the check compares each step's loss, each
leaf's first-gradient norm and each leaf's norm of change over the three
steps. ``train_clips_per_s`` counts the clips of the window's complete
steps over all its time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import frames
from portbench.drivers.live import build_model
from portbench.reference.models import RefAViNet

BETA1 = 0.9  # Adam's first-moment decay: moment after step 1 = (1 - BETA1) * gradient


class State:
    pass


def _pool(cell) -> dict:
    """Host arrays of ``pool`` clips (uint8), GT maps (f32 in [0, 1]) and
    Hanning-windowed audio excerpts, from the seed."""
    cfg, n = cell.config, cell.traffic["pool"]
    h, w, t = cfg["input_h"], cfg["input_w"], cfg["clip_size"]
    clips = np.stack([frames.video(cell.seed, 100 + i, t, h, w, cell.device).cpu().numpy()
                      for i in range(n)])
    g = frames.generator(cell.seed, 99, cell.device)
    yy = torch.arange(h, device=cell.device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=cell.device, dtype=torch.float32)[None, None, :]
    c = torch.rand((n, 3, 2), generator=g, device=cell.device) * torch.tensor(
        [h, w], device=cell.device)
    sig = (0.03 + 0.1 * torch.rand((n, 3), generator=g, device=cell.device)) * min(h, w)
    gt = sum(torch.exp(-((yy - c[:, k, 0, None, None]) ** 2 + (xx - c[:, k, 1, None, None]) ** 2)
                       / (2 * sig[:, k, None, None] ** 2)) for k in range(3))
    gt = (gt / gt.amax(dim=(1, 2), keepdim=True)).cpu().numpy()
    win = torch.hann_window(cfg["audio_window"], periodic=False, device=cell.device)
    audio = torch.stack([frames.audio(cell.seed, 100 + i, cfg["audio_window"], cfg["audio_fs"],
                                      cell.device) * win for i in range(n)])
    return {"clip": clips, "gt": gt, "audio": audio[..., None].cpu().numpy()}


def _rows(cell, step: int) -> np.ndarray:
    """Pool rows of step (0-based): pass p = step * batch // pool takes the
    pool in a seeded order, so the first pool // batch steps see all
    different clips."""
    b, n = cell.traffic["batch"], cell.traffic["pool"]
    per = n // b
    p, j = divmod(step, per)
    order = frames.rng(cell.seed, 17, p).permutation(n)
    return order[j * b: (j + 1) * b]


def host_batch(st, cell, step: int) -> dict:
    r = _rows(cell, step)
    return {k: v[r] for k, v in st.pool.items()}


def setup(cell) -> State:
    from vinet_tpu_torch.cli.train import to_device
    from vinet_tpu_torch.training.losses import LossConfig
    from vinet_tpu_torch.training.trainer import init_train_state, make_train_step

    tr = cell.traffic
    if tr["pool"] < 3 * tr["batch"]:
        raise ValueError("the pool must hold the first three steps' clips")
    st = State()
    st.to_device = to_device
    model, _ = build_model(cell)
    st.ts = init_train_state(model.float().to(cell.device), tr["lr"])
    dtype = cell.config["dtype"]  # the convolutions' dtype; float32 runs without autocast
    st.step_fn = make_train_step(LossConfig(), compute_dtype=None if dtype == "float32"
                                 else getattr(torch, dtype))
    st.pool = _pool(cell)
    st.steps = 0
    st.losses = []
    names = [n for n, _ in st.ts.model.named_parameters()]
    for k in range(3):
        _, out = step(st, cell)
        st.losses.append(float(out["loss"]))
        if k == 0:
            opt = st.ts.optimizer
            st.moment1 = {n: opt.state[p]["exp_avg"].detach().cpu().clone()
                          for n, p in zip(names, st.ts.model.parameters()) if p in opt.state}
    st.params3 = {n: p.detach().cpu().clone() for n, p in st.ts.model.named_parameters()}
    for _ in range(tr["warm_steps"]):
        step(st, cell)
    _sync(cell)
    return st


def _sync(cell):
    if cell.device != "cpu":
        torch.cuda.synchronize()


def step(st, cell):
    batch = st.to_device(host_batch(st, cell, st.steps), cell.device)
    st.steps += 1
    return st.step_fn(st.ts, batch)


def window(st, cell) -> dict:
    _sync(cell)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < cell.seconds:
        step(st, cell)
        n += 1
    _sync(cell)
    elapsed = time.perf_counter() - t0
    clips = n * cell.traffic["batch"]
    return {"train_clips_per_s": clips / elapsed, "window_s": elapsed,
            "attempted": clips, "failed": 0}


def traced_work(st, cell):
    return lambda: [step(st, cell) for _ in range(cell.traffic["trace_steps"])]


def release(st) -> None:
    st.ts = st.step_fn = None


def reference_steps(st, cell, quant: bool = False, rows: slice = slice(None),
                    bf16: bool = False) -> tuple:
    """The plain reference's three steps in float64 from the seed's weights
    on the first three batches: (losses, first gradients, parameters after
    step 3, initial parameters), tensors on the CPU by name. Float64, so
    that a leaf whose gradient is nought (a conv bias under train-mode
    BatchNorm, as SoundNet's) reads nought to rounding: in f32 its summed
    round-off over 8 x 35 281 positions reads half the median leaf's.
    bf16=True: f32 weights under bf16 autocast instead, the plain witness
    of what bf16 alone does to the numbers compared."""
    from portbench.reference.post import normalise

    cfg = cell.config
    _, sd = build_model(cell)
    model = RefAViNet((4, cfg["input_h"] // 32, cfg["input_w"] // 32))
    model.load_state_dict(sd, strict=True)
    dtype = torch.float32 if bf16 else torch.float64
    model = model.to(dtype).to(cell.device).train()
    model.quant.on = quant
    params0 = {n: p.detach().cpu().float() for n, p in model.named_parameters()}
    opt = torch.optim.Adam(model.parameters(), lr=cell.traffic["lr"], betas=(BETA1, 0.999),
                           eps=1e-8)
    losses, grads1 = [], {}
    for k in range(3):
        hb = {key: v[rows] for key, v in host_batch(st, cell, k).items()}
        x = torch.stack([normalise(torch.from_numpy(c).to(cell.device)) for c in hb["clip"]])
        gt = torch.from_numpy(hb["gt"]).to(cell.device).to(dtype)
        audio = torch.from_numpy(hb["audio"][..., 0]).to(cell.device).to(dtype)
        opt.zero_grad(set_to_none=True)
        with torch.autocast(torch.device(cell.device).type, dtype=torch.bfloat16, enabled=bf16):
            pred = model(x.to(dtype), audio)
        loss = kldiv(pred.to(dtype), gt)
        loss.backward()
        losses.append(float(loss.detach()))
        if k == 0:
            grads1 = {n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters() if p.grad is not None}
        opt.step()
    params3 = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return losses, grads1, params3, params0


def kldiv(pred: torch.Tensor, gt: torch.Tensor, eps: float = 2.2204e-16) -> torch.Tensor:
    """The published loss.py kldiv: KL(gt || pred) of the sum-normalised
    maps, summed over pixels, mean over the batch."""
    s = pred.flatten(1)
    s = s / s.sum(1, keepdim=True)
    g = gt.flatten(1)
    g = g / g.sum(1, keepdim=True)
    return (g * torch.log(eps + g / (s + eps))).sum(1).mean()


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Leaf -> |‖prog‖ - ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖), over
    the leaves whose reference norm is at least a thousandth of the median
    leaf's (the others move by round-off alone); a leaf the program left
    without a value reads 1."""
    norms = {n: float(v.double().norm()) for n, v in ref.items()}
    med = float(np.median(list(norms.values())))
    return {n: abs(float(prog[n].double().norm()) - r) / max(r, med) if n in prog else 1.0
            for n, r in norms.items() if r >= 1e-3 * med}


def readings(st, ref: tuple) -> dict:
    """The readings of a kept state against a reference run: the relative
    gap of the first step's loss and the largest of the three, and of the
    per-leaf norm gaps of the first gradient and of the change over three
    steps the worst leaf's and the median leaf's."""
    losses, grads1, params3, params0 = ref
    g = leaf_gaps({n: m / (1 - BETA1) for n, m in st.moment1.items()}, grads1)
    d = leaf_gaps({n: st.params3[n] - params0[n] for n in params0},
                  {n: params3[n] - params0[n] for n in grads1})
    gaps = [abs(a - b) / abs(b) for a, b in zip(st.losses, losses)]
    return {"loss1_rel_gap": gaps[0], "loss_rel_gap": max(gaps),
            "grad_norm_gap": max(g.values()),
            "grad_norm_gap_median": float(np.median(list(g.values()))),
            "update_norm_gap": max(d.values()),
            "update_norm_gap_median": float(np.median(list(d.values())))}


def check(st, cell, limits: dict) -> tuple:
    got = readings(st, reference_steps(st, cell))
    compared = {k: {"value": got[k], "limit": v} for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared


def _as_state(ref: tuple) -> State:
    """A reference run as the kept state of a program in its place."""
    st = State()
    st.losses, st.params3 = ref[0], ref[2]
    st.moment1 = {n: (1 - BETA1) * g for n, g in ref[1].items()}
    return st


def control(cell, seeds: list, _n: int) -> list:
    """Per seed, each against the float64 reference: the program's readings
    (a sound set-up); the control's, the reference with int8-rounded
    convolutions and straight-through gradients in the program's place; a
    planted fault's, the reference's steps on half of each batch (the mean
    over the rest); and the witness's, the plain reference under bf16
    autocast, which shows what bf16 alone does to each number."""
    rows = []
    for seed in seeds:
        cell.seed = seed
        st = setup(cell)
        ref = reference_steps(st, cell)
        half = slice(0, cell.traffic["batch"] // 2)
        worst = leaf_gaps({n: m / (1 - BETA1) for n, m in st.moment1.items()}, ref[1])
        other = lambda **kw: readings(_as_state(reference_steps(st, cell, **kw)), ref)  # noqa: E731
        rows.append({
            "seed": seed, "program": readings(st, ref),
            "control_int8_reference": other(quant=True),
            "fault_half_batch": other(rows=half),
            "witness_bf16_reference": other(bf16=True),
            "program_worst_grad_leaves": sorted(worst.items(), key=lambda kv: -kv[1])[:4]})
        release(st)
        del st
        if cell.device != "cpu":
            torch.cuda.empty_cache()
    return rows
