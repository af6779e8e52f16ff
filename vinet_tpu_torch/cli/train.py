"""Training CLI (reference train.py), ``vinet_tpu/cli/train.py`` on PyTorch.

Trains visual ViNet, or AViNet with --use_sound True (its refinement
encoder with --use_transformer True), with Adam on --device (default cuda;
asking for cuda without a card raises). Data: DHF1KDataset, Hollywood/UCF
(HollywoodUCFDataset), or SoundDataset, the six audio-visual sets of the
STAViS layout under --train_path_data in train mode, validated on the same
six in test mode (--split picks the fold lists; --val_path_data is not
read, as in the JAX package). SoundDataset decodes its frames at the
model's --input_h x --input_w; the other sets at 224 x 384.

Each epoch ends with BatchNorm recalibration (--bn_recal, the audio's
statistics too), validation (an f32 forward in eval mode with the window's
audio, resized to the native GT size, blurred, then loss / cc / sim; on a
card the decoder ends in the fused head kernel), a full train-state
checkpoint under --checkpoint_dir (``io/checkpoint.py``; --resume continues
from the latest step with the same dropout stream), and the best model at
--model_val_path: a reference-named state_dict (``io/export.py``), or for a
path ending in .npz the JAX package's trees (``io/weights.py::save_npz_trees``,
what the JAX CLI writes there), which ``io/weights.py::load_weights``,
``generate_result --file_weight``, ``generate_result_audio_visual
--file_weight`` and the JAX CLIs read. --lr_sched decays the rate 10x every
--step_size epochs of optimizer steps, an epoch being the shortest shard's
uncapped step count on every rank (``max_steps_per_epoch`` does not shorten
it, as in the JAX CLI, which counts each process's own shard). --streaming_ft
fine-tunes visual ViNet through the streaming forward instead
(``training/streaming_ft.py``).

Parallelism (``parallel/``) follows the JAX CLI, one process a card. The
CLI joins its torch.distributed world (``utils/runtime.py::init_distributed``:
the VINET_* variables or torchrun's; one process without either) and builds
a ("data", "model") mesh. Without --multihost, --batch_size is the global
batch: every rank walks the same loader and each data rank runs its rows;
the data axis is gcd(batch_size, world // model_axis), and ranks left out of
the mesh stop at startup. With --multihost, --batch_size is per process,
each rank's loader takes its shard of the samples and the global batch is
the ranks' batches in rank order. BatchNorm takes the global batch's
statistics, --model_axis N shards the parameters and their Adam state N
ways (``training/trainer.py``), and the step equals one process's on the
global batch. Validation is replicated; rank 0 alone writes the checkpoint
and the best model. --multihost with --model_axis > 1 stops at startup, as
in the JAX package, as does --streaming_ft with --use_sound True;
--streaming_ft ignores --multihost and runs in each process alone.

Usage (DHF1K; the six AV sets: --dataset SoundDataset --split 1
--use_sound True --train_path_data STAVIS_ROOT):
  python -m vinet_tpu_torch.cli.train --train_path_data D/annotation \
      --val_path_data D/val --no_epochs 40 --batch_size 8 --bf16 \
      [--file_weight S3D_kinetics400.pt] [--checkpoint_dir ck --resume]
On N cards of one host:
  torchrun --standalone --nproc_per_node N -m vinet_tpu_torch.cli.train \
      --multihost --batch_size 8 ...
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch


def build_parser():
    from vinet_tpu_torch.cli.common import add_bool_flag, add_model_args

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--no_epochs", type=int, default=40)
    p.add_argument("--lr", type=float, default=1e-4)
    for flag, default in (("kldiv", True), ("cc", False), ("nss", False), ("sim", False),
                          ("l1", False), ("lr_sched", False)):
        add_bool_flag(p, flag, default)
    p.add_argument("--kldiv_coeff", type=float, default=1.0)
    p.add_argument("--cc_coeff", type=float, default=-1.0)
    p.add_argument("--sim_coeff", type=float, default=-1.0)
    p.add_argument("--nss_coeff", type=float, default=1.0)
    p.add_argument("--l1_coeff", type=float, default=1.0)
    p.add_argument("--step_size", type=int, default=5,
                   help="with --lr_sched, decay 0.1x every step_size epochs' worth of "
                        "optimizer steps (step_size * batches per epoch)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per step: the batch's memory is that of "
                        "batch_size/N clips per forward")
    p.add_argument("--log_interval", type=int, default=5)
    p.add_argument("--no_workers", type=int, default=4)
    p.add_argument("--train_path_data", type=str, required=True)
    p.add_argument("--val_path_data", type=str, default=None)
    p.add_argument("--dataset", type=str, default="DHF1KDataset",
                   choices=["DHF1KDataset", "SoundDataset", "Hollywood", "UCF"])
    p.add_argument("--alternate", type=int, default=1)
    p.add_argument("--split", type=int, default=-1,
                   help="SoundDataset: the fold lists' split (DIEM's have none)")
    p.add_argument("--multi_frame", type=int, default=0)
    p.add_argument("--model_val_path", type=str, default="vinet_best.pt",
                   help="best-validation weights: a reference-named state_dict (.pt), "
                        "or the JAX package's trees for a path ending in .npz")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="directory of full train-state checkpoints, one a epoch")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--file_weight", type=str, default=None,
                   help="S3D Kinetics-400 backbone (S3D_kinetics400.pt) or a full model")
    p.add_argument("--load_weight", type=str, default=None,
                   help="full-model weights to start from (.pt or .npz)")
    p.add_argument("--max_steps_per_epoch", type=int, default=0, help="0 = full epoch")
    p.add_argument("--model_axis", type=int, default=1,
                   help="mesh model-parallel size: parameters and Adam state sharded N ways")
    p.add_argument("--bn_recal", type=int, default=0,
                   help="N > 0: before each validation, replace the BatchNorm running "
                        "statistics with the mean batch statistics of the first N train "
                        "batches (for from-scratch runs, where momentum 0.001 leaves them "
                        "near their init); 0 = reference behaviour")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 convolutions; f32 master weights, Adam state and BN statistics")
    p.add_argument("--multihost", action="store_true",
                   help="--batch_size per process and the data loaders sharded per process "
                        "(the world comes from torchrun or the VINET_* variables)")
    p.add_argument("--streaming_ft", action="store_true",
                   help="streaming-consistent fine-tune through the --streaming forward on "
                        "contiguous chunks, BatchNorm statistics frozen; needs --load_weight "
                        "(DHF1K layout)")
    p.add_argument("--ft_chunk", type=int, default=64,
                   help="--streaming_ft chunk length (frames, a multiple of 8)")
    p.add_argument("--ft_windows", type=int, default=16,
                   help="--streaming_ft loss windows per chunk step")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless asked for cpu")
    add_model_args(p)
    return p


def check_supported(args) -> None:
    """Stop at startup on what the CLI does not do."""
    if args.multihost and args.model_axis > 1 and not args.streaming_ft:
        raise SystemExit("--multihost with --model_axis>1 is unsupported; "
                         "use --model_axis 1 under --multihost")
    if args.batch_size % args.grad_accum:
        raise SystemExit("--batch_size must be divisible by --grad_accum")
    if args.streaming_ft:
        if args.use_sound:
            raise SystemExit("--streaming_ft fine-tunes visual ViNet only, not --use_sound True")
        if args.grad_accum != 1:
            raise SystemExit("--grad_accum is not supported with --streaming_ft (the "
                             "chunked step already amortises the backbone; scale "
                             "--ft_windows instead)")
        if args.ft_chunk % 8 or args.ft_chunk < args.clip_size:
            raise SystemExit(f"--ft_chunk must be a multiple of 8 and >= --clip_size, "
                             f"got {args.ft_chunk}")


def loss_config(args):
    from vinet_tpu_torch.training import LossConfig

    return LossConfig(kldiv=args.kldiv, cc=args.cc, sim=args.sim, nss=args.nss, l1=args.l1,
                      kldiv_coeff=args.kldiv_coeff, cc_coeff=args.cc_coeff,
                      sim_coeff=args.sim_coeff, nss_coeff=args.nss_coeff,
                      l1_coeff=args.l1_coeff)


def make_datasets(args):
    from vinet_tpu_torch.cli.common import model_input_size
    from vinet_tpu_torch.data.datasets import (AV_DATASETS, ConcatDataset, DHF1KDataset,
                                               HollywoodUCFDataset, SoundDataset)

    if args.dataset == "DHF1KDataset":
        train = DHF1KDataset(args.train_path_data, args.clip_size, mode="train",
                             multi_frame=args.multi_frame, alternate=args.alternate)
        val = (DHF1KDataset(args.val_path_data, args.clip_size, mode="val",
                            alternate=args.alternate) if args.val_path_data else None)
    elif args.dataset == "SoundDataset":
        sets = {mode: ConcatDataset([SoundDataset(args.train_path_data, args.clip_size,
                                                  dataset_name=ds, split=args.split, mode=mode,
                                                  use_sound=args.use_sound,
                                                  size=model_input_size(args))
                                     for ds in AV_DATASETS])
                for mode in ("train", "test")}
        train, val = sets["train"], sets["test"]
    else:
        train = HollywoodUCFDataset(args.train_path_data, args.clip_size, mode="train",
                                    multi_frame=args.multi_frame)
        val = (HollywoodUCFDataset(args.val_path_data, args.clip_size, mode="val")
               if args.val_path_data else None)
    return train, val


def build_train_model(args, device):
    """ViNet (AViNet with --use_sound True) with --file_weight, then
    --load_weight, in f32 on device."""
    from vinet_tpu_torch.cli.common import build_model, has_weights
    from vinet_tpu_torch.io.weights import load_model_weights

    model = build_model(args)
    if has_weights(args.load_weight):
        load_model_weights(model, args.load_weight)
    return model.float().to(device)


def save_best(args, model, epoch: int) -> None:
    """The best model at --model_val_path: the JAX package's .npz trees for a
    path ending in .npz (what the JAX CLI writes there), else the
    reference's torch .pt."""
    from vinet_tpu_torch.io.export import export_torch_checkpoint
    from vinet_tpu_torch.io.weights import save_npz_trees, to_jax_trees

    print("[%2d,  save, %s]" % (epoch, args.model_val_path), flush=True)
    if args.model_val_path.endswith(".npz"):
        save_npz_trees(args.model_val_path, *to_jax_trees(model.state_dict()))
    else:
        export_torch_checkpoint(args.model_val_path, model)


def _upload(host: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.asarray(host, dtype)).to(device)


def to_device(batch: dict, device) -> dict:
    """A host batch on device: the clip normalised there, the GT and the
    audio (where the batch has it) as f32."""
    from vinet_tpu_torch.data.pipeline import device_preprocess
    from vinet_tpu_torch.utils import trace

    with trace.span("train.upload") as attrs:
        out = {"clip": device_preprocess(_upload(batch["clip"], device))}
        for k in ("gt", "audio"):
            if k in batch:
                out[k] = _upload(batch[k], device, np.float32)
        if attrs is not None:  # the uint8 clips and the f32 GT and audio
            attrs["bytes"] = (np.asarray(batch["clip"]).nbytes
                              + sum(v.nbytes for k, v in out.items() if k != "clip"))
    return out


def run_streaming_ft(args, device) -> int:
    """--streaming_ft: chunk batches through the streaming forward, BN
    statistics frozen; the best validation model saved like the main loop's."""
    from vinet_tpu_torch.data.datasets import ChunkDataset
    from vinet_tpu_torch.data.pipeline import Loader, device_preprocess
    from vinet_tpu_torch.training.streaming_ft import (eval_window_starts,
                                                       make_streaming_eval_step,
                                                       make_streaming_ft_step,
                                                       sample_window_starts)
    from vinet_tpu_torch.training.trainer import AverageMeter, init_train_state

    if not (args.load_weight or args.file_weight):
        print("warning: --streaming_ft without --load_weight fine-tunes a random init "
              "with FROZEN BatchNorm statistics", flush=True)
    model = build_train_model(args, device)
    loss_cfg = loss_config(args)
    train_loader = Loader(ChunkDataset(args.train_path_data, args.ft_chunk), batch_size=1,
                          shuffle=True, num_workers=args.no_workers, seed=0)
    val_loader = (Loader(ChunkDataset(args.val_path_data, args.ft_chunk, mode="val"),
                         batch_size=1, shuffle=False, num_workers=args.no_workers,
                         drop_last=False) if args.val_path_data else None)
    ts = init_train_state(model, args.lr)
    step_fn = make_streaming_ft_step(loss_cfg, clip_size=args.clip_size,
                                     compute_dtype=torch.bfloat16 if args.bf16 else None)
    eval_fn = make_streaming_eval_step(loss_cfg, clip_size=args.clip_size)
    val_starts = eval_window_starts(args.ft_windows, args.ft_chunk, args.clip_size)

    def to_batch(host, starts):
        return {"chunk": device_preprocess(_upload(host["clip"], device)),
                "gt": _upload(host["gts"][0][starts + args.clip_size - 1], device, np.float32),
                "starts": _upload(starts, device, np.int64)}

    best_loss = float("inf")
    for epoch in range(args.no_epochs):
        tic = time.time()
        rng = np.random.default_rng((1234, epoch))
        total, cur = AverageMeter(), AverageMeter()
        for idx, host in enumerate(train_loader):
            if args.max_steps_per_epoch and idx >= args.max_steps_per_epoch:
                break
            starts = sample_window_starts(rng, args.ft_windows, args.ft_chunk, args.clip_size)
            ts, metrics = step_fn(ts, to_batch(host, starts))
            loss = float(metrics["loss"])
            total.update(loss)
            cur.update(loss)
            if idx % args.log_interval == args.log_interval - 1:
                print("[%2d, %5d] avg_loss : %.5f, time:%3f minutes"
                      % (epoch, idx, cur.avg, (time.time() - tic) / 60), flush=True)
                cur.reset()
        print("[%2d, train] avg_loss : %.5f" % (epoch, total.avg), flush=True)

        if val_loader is not None:
            vl, vc, vs = AverageMeter(), AverageMeter(), AverageMeter()
            for host in val_loader:
                m = eval_fn(ts, to_batch(host, val_starts))
                vl.update(float(m["loss"]))
                vc.update(float(m["cc"]))
                vs.update(float(m["sim"]))
            print("[%2d, val] avg_loss : %.5f cc_loss : %.5f sim_loss : %.5f, time : %3f"
                  % (epoch, vl.avg, vc.avg, vs.avg, (time.time() - tic) / 60), flush=True)
            val_loss = vl.avg
        else:
            val_loss = total.avg
        if val_loss <= best_loss:
            best_loss = val_loss
            save_best(args, model, epoch)
    return 0


def validate(model, val_loader, loss_cfg, device) -> tuple:
    """The reference's validation: f32 maps in eval mode (with the window's
    audio for AViNet), resized to the native GT size, blurred; mean (loss,
    cc, sim) over the batches."""
    from vinet_tpu_torch.ops.image import gaussian_blur, resize_bilinear
    from vinet_tpu_torch.training.losses import cc, loss_func, similarity
    from vinet_tpu_torch.training.trainer import AverageMeter, predict

    vl, vc, vs = AverageMeter(), AverageMeter(), AverageMeter()
    for host in val_loader:
        batch = to_device(host, device)
        pred = predict(model, batch["clip"], batch.get("audio"))
        gt = batch["gt"]
        pred = gaussian_blur(resize_bilinear(pred, *gt.shape[1:]))
        vl.update(float(loss_func(pred, gt, loss_cfg)))
        vc.update(float(cc(pred, gt)))
        vs.update(float(similarity(pred, gt)))
    return vl.avg, vc.avg, vs.avg


def training_mesh(args, world: int):
    """The mesh of the JAX CLI (its cli/train.py:316-353) over this world:
    with --multihost every rank on the data axis; otherwise a data axis of
    gcd(batch_size, world // model_axis), so that every data rank gets as
    many rows, over the first data * model_axis ranks."""
    from vinet_tpu_torch.parallel import create_mesh

    data = (world if args.multihost
            else math.gcd(args.batch_size, world // args.model_axis))
    n = min(data * args.model_axis, world)
    try:
        mesh = create_mesh(n, model=args.model_axis)
    except ValueError as e:
        raise SystemExit(f"--model_axis {args.model_axis}: {e}")
    if n < world:
        print(f"using {n}/{world} devices (batch_size {args.batch_size} limits the data axis)",
              flush=True)
    return mesh


def run(args) -> int:
    from vinet_tpu_torch.data.pipeline import Loader
    from vinet_tpu_torch.device import resolve_device
    from vinet_tpu_torch.io.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from vinet_tpu_torch.parallel import gather_batch
    from vinet_tpu_torch.training.trainer import (AverageMeter, init_train_state,
                                                  make_bn_stats_fn, make_train_step,
                                                  recalibrate_bn, step_decay)
    from vinet_tpu_torch.utils.runtime import init_distributed

    check_supported(args)
    device = resolve_device(args.device)
    if args.streaming_ft:
        return run_streaming_ft(args, device)
    rank, world = init_distributed(args.device)
    mesh = training_mesh(args, world)
    if mesh.coords is None:
        print(f"rank {rank} is outside the {mesh.size}-rank mesh: nothing to do", flush=True)
        return 0

    model = build_train_model(args, device)
    loss_cfg = loss_config(args)
    train_ds, val_ds = make_datasets(args)
    train_loader = Loader(train_ds, batch_size=args.batch_size, shuffle=True,
                          num_workers=args.no_workers, seed=0,
                          shard=(rank, world) if args.multihost else (0, 1))
    val_loader = (Loader(val_ds, batch_size=1, shuffle=False, num_workers=args.no_workers,
                         drop_last=False) if val_ds else None)
    steps_per_epoch = len(train_loader)
    if args.multihost and world > 1:  # every rank takes as many steps as the shortest shard
        n = torch.tensor([steps_per_epoch], device=device)
        torch.distributed.all_reduce(n, op=torch.distributed.ReduceOp.MIN)
        steps_per_epoch = int(n)
    # the reference's --lr_sched names an undefined scheduler; here, as in the
    # JAX package, 0.1x every step_size epochs' worth of optimizer steps, an
    # epoch counted uncapped as JAX counts it, but the same on every rank
    # (JAX's CLI takes each process's own loader length)
    schedule = (step_decay(args.lr, args.step_size * max(1, steps_per_epoch))
                if args.lr_sched else None)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    ts = init_train_state(model, args.lr, lr_schedule=schedule, mesh=mesh)
    if args.resume and args.checkpoint_dir and latest_step(args.checkpoint_dir) is not None:
        restore_checkpoint(args.checkpoint_dir, ts)
        print(f"resumed from step {ts.step}", flush=True)

    step_fn = make_train_step(loss_cfg, compute_dtype=torch.bfloat16 if args.bf16 else None,
                              grad_accum=args.grad_accum, mesh=mesh)
    stats_fn = make_bn_stats_fn(model, mesh) if args.bn_recal else None

    def global_batch(host: dict) -> dict:
        """A train batch on the device as the global batch: under --multihost
        the ranks' batches in rank order (JAX's _globalize)."""
        batch = to_device(host, device)
        return {k: gather_batch(v, mesh) for k, v in batch.items()} if args.multihost else batch

    calib_host = []  # host batches kept for BN recalibration
    best_loss = float("inf")
    for epoch in range(args.no_epochs):
        tic = time.time()
        total, cur = AverageMeter(), AverageMeter()
        for idx, batch in enumerate(train_loader):
            if idx >= steps_per_epoch:
                break
            if len(calib_host) < args.bn_recal:
                calib_host.append({k: v for k, v in batch.items() if k in ("clip", "audio")})
            ts, metrics = step_fn(ts, global_batch(batch))
            loss = float(metrics["loss"])
            total.update(loss)
            cur.update(loss)
            if idx % args.log_interval == args.log_interval - 1:
                print("[%2d, %5d] avg_loss : %.5f, time:%3f minutes"
                      % (epoch, idx, cur.avg, (time.time() - tic) / 60), flush=True)
                cur.reset()
        print("[%2d, train] avg_loss : %.5f" % (epoch, total.avg), flush=True)

        if calib_host:  # global batches, as the train steps'
            recalibrate_bn(model, (global_batch(b) for b in calib_host), stats_fn=stats_fn)
        if val_loader is not None:  # replicated: every rank walks the same loader
            val_loss, val_cc, val_sim = validate(model, val_loader, loss_cfg, device)
            print("[%2d, val] avg_loss : %.5f cc_loss : %.5f sim_loss : %.5f, time : %3f"
                  % (epoch, val_loss, val_cc, val_sim, (time.time() - tic) / 60), flush=True)
        else:
            val_loss = total.avg
        if args.checkpoint_dir:  # every rank gathers the shards, rank 0 writes
            save_checkpoint(args.checkpoint_dir, ts, write=rank == 0)
        if val_loss <= best_loss:
            best_loss = val_loss
            if rank == 0:
                save_best(args, model, epoch)
    return 0


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
