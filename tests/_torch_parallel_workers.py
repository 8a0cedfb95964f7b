"""Gloo worlds of CPU processes for the port's multi-device tests
(tests/test_torch_parallel*.py, tests/test_torch_spatial*.py), and the
work each rank does in them.

This module imports no JAX: the test files (and tests/conftest.py) import
JAX, and a spawned child imports only the module of its target. Each
world rendezvouses through a file under the test's ``tmp_path`` (no
port, so parallel pytest workers never collide), and every wait has a
timeout: a rank that hangs or dies fails the test.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
import uuid

import numpy as np
import torch

PORT = "segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch"


def _entry(rank, world, rdv, fn_name, args, q, threads=2):
    torch.set_num_threads(threads)
    import torch.distributed as dist
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel.mesh import (
        initialize_distributed)
    try:
        initialize_distributed(f"file://{rdv}", world, rank,
                               backend="gloo", device="cpu")
        q.put((rank, True, globals()[fn_name](rank, world, *args)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """A gloo world of ``world`` CPU processes running ``fn_name(rank,
    world, *args)`` on ``threads`` torch threads each, started at
    construction; ``results()`` waits for it (bounded by ``timeout``
    from the start), so the caller can work while the ranks run."""

    def __init__(self, fn_name: str, args: tuple, tmp_path, world: int = 2,
                 timeout: float = 150.0, threads: int = 2):
        ctx = mp.get_context("spawn")
        self.fn_name, self.world = fn_name, world
        self.q = ctx.Queue()
        rdv = tmp_path / f"rdv_{uuid.uuid4().hex}"
        self.procs = [ctx.Process(target=_entry,
                                  args=(r, world, str(rdv), fn_name, args,
                                        self.q, threads))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def stop(self) -> None:
        """Stop every process still running (a world whose results no
        test asked for: its ranks would wait on the queue for ever)."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)

    def results(self) -> list:
        """The ranks' results in rank order; a rank that fails, dies or
        passes the timeout fails the caller, and every process is
        stopped."""
        fn_name, procs, results = self.fn_name, self.procs, {}
        try:
            while len(results) < self.world:
                try:
                    rank, ok, out = self.q.get(timeout=1.0)
                except queue.Empty:
                    codes = [p.exitcode for p in procs]
                    if any(c not in (None, 0) for c in codes):
                        raise AssertionError(f"{fn_name}: a rank died "
                                             f"(exit codes {codes})")
                    if time.monotonic() > self.deadline:
                        raise AssertionError(
                            f"{fn_name}: no result within {self.timeout} s "
                            f"(exit codes {codes})")
                    continue
                if not ok:
                    raise AssertionError(f"{fn_name} rank {rank}:\n{out}")
                results[rank] = out
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode
                                                     for p in procs]
        return [results[r] for r in range(self.world)]


def run_world(fn_name: str, args: tuple, tmp_path, world: int = 2,
              timeout: float = 150.0) -> list:
    """``fn_name(rank, world, *args)`` on each rank of a gloo world of
    CPU processes; the ranks' results in rank order."""
    return World(fn_name, args, tmp_path, world, timeout).results()


def _np(t):
    return t.detach().cpu().numpy()


def _unet(state, **kw):
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
        UNet3D)
    model = UNet3D(device="cpu", **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.eval()
    return model


def _ndhwc_conv(w: torch.Tensor, padding):
    """An NDHWC conv with a DHWIO kernel, f32."""
    wn = w.permute(4, 3, 0, 1, 2).contiguous()

    def conv(v):
        y = torch.nn.functional.conv3d(v.permute(0, 4, 1, 2, 3), wn,
                                       padding=padding)
        return y.permute(0, 2, 3, 4, 1)
    return conv


# ---------------------------------------------------------------- worlds

def spatial(rank, world, x, w):
    """The halo exchange and the two sharded convs on this rank's D
    slab of ``x`` over a (1, 2) mesh."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        mesh as M, spatial as S)
    m = M.create_mesh(1, 2)
    slab = M.shard_batch(torch.from_numpy(x), m)
    g = m.group("space")
    wt = torch.from_numpy(w)
    out = {"shape": dict(m.shape), "coords": m.coords,
           "grid": m.devices.tolist(),
           "constrained": tuple(S.constrain_spatial(
               slab, m, depth=x.shape[1]).shape)}
    for b in ("edge", "zero"):
        for h in (1, 2):
            out[f"{b}{h}"] = _np(S.halo_exchange_d(slab, h, g, b))
    out["sharded"] = _np(S.sharded_conv3d(m, _ndhwc_conv(wt, 1))(slab))
    out["zero_boundary"] = _np(S.zero_boundary_halo_conv(
        m, _ndhwc_conv(wt, (0, 1, 1)))(slab))
    return out


def inference(rank, world, plain_state, ps2d_state, vols, vol):
    """DP cohort segmentation (N = 5, padded) and window-parallel
    sliding windows, plain and through the ps2d region."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.sliding_window import (
        sliding_window_inference)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        create_mesh, segment_cohort, segment_cohort_whole,
        sliding_window_inference_mp)
    mesh = create_mesh()
    plain = _unet(plain_state, features=(8, 16), compute_dtype="float32")
    out = {"mesh": dict(mesh.shape)}
    out["cohort"] = segment_cohort(plain, None, mesh, vols)
    out["whole"] = segment_cohort_whole(plain, None, mesh, vols,
                                        (16, 16, 16), batch_per_chip=2)
    sw = dict(roi_size=(16, 16, 16), overlap=0.5, sw_batch_size=2)
    v = torch.from_numpy(vol)
    with torch.no_grad():
        out["window"] = _np(sliding_window_inference_mp(v, plain, mesh,
                                                        **sw))
        ps2d = _unet(ps2d_state, features=(32, 64), ps2d_eval=True,
                     ps2d_levels=2, compute_dtype="float32")
        out["halo_levels"] = ps2d.halo_levels((16, 16, 16))
        # the level-1 region's pool (K4's wrapper), counted
        from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
            unet3d)
        pool, calls = unet3d.pool_into_halo, []
        unet3d.pool_into_halo = lambda x: calls.append(1) or pool(x)
        out["window_ps2d"] = _np(sliding_window_inference_mp(v, ps2d, mesh,
                                                             **sw))
        unet3d.pool_into_halo = pool
        out["pools"] = len(calls)
        out["window_ps2d_one"] = _np(sliding_window_inference(v, ps2d, **sw))
    return out


def _train_config(remat=False):
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
        config as C)
    return C.Config(model=C.ModelConfig(features=(8, 16),
                                        compute_dtype="float32",
                                        remat=remat, dropout_rate=0.0),
                    use_tensorboard=False)


def dp_train_step(model, batch, mesh=None, grad_accum=None,
                  joint=False, config=None):
    """One train step of ``model`` on ``batch`` (this rank's rows when
    ``mesh``; its D slab too on a ``space`` mesh): its metrics, the
    gradients handed to the optimizer (by parameter name), the new
    BatchNorm statistics and the parameters after the update, as
    numpy."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
        create_train_state, make_joint_train_step, make_train_step)
    cfg = config or _train_config()
    state = create_train_state(model, cfg)
    seen = {}
    apply = state.apply_gradients

    def capture(grads, batch_stats=None):
        seen["grads"] = [g.detach().clone() for g in grads]
        return apply(grads, batch_stats=batch_stats)
    state.apply_gradients = capture
    make = make_joint_train_step if joint else make_train_step
    kw = {} if joint else {"grad_accum": grad_accum}
    step = make(cfg, mesh=mesh, **kw)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, metrics = step(state, tb, torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters()]
    bn = model.unet.head_bn if joint else model.head_bn
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: _np(g) for n, g in zip(names, seen["grads"])},
            "bn": (_np(bn.mean), _np(bn.var)),
            "params": {n: _np(p) for n, p in model.named_parameters()}}


def dp_eval_step(model, batch, mesh=None):
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
        create_train_state, make_eval_step)
    cfg = _train_config()
    state = create_train_state(model, cfg)
    step = make_eval_step(cfg, with_hausdorff=True, mesh=mesh)
    m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {k: _np(v) for k, v in m.items()}


def joint_model(state):
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
        UNet3DWithClassifier)
    model = UNet3DWithClassifier(features=(8, 16), device="cpu",
                                 dropout_rate=0.0, compute_dtype="float32")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.grade_dropout = 0.0
    return model


def training(rank, world, state, joint_state, batch):
    """The train step (and with ``grad_accum=2``), the joint step and the
    eval step on this rank's rows of ``batch`` over a data mesh."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        create_mesh, shard_batch)
    mesh = create_mesh()
    local = shard_batch(batch, mesh)
    kw = dict(features=(8, 16), compute_dtype="float32", dropout_rate=0.0)
    return {
        "rows": local["image"].shape[0],
        "step": dp_train_step(_unet(state, **kw), local, mesh),
        "accum": dp_train_step(_unet(state, **kw), local, mesh,
                               grad_accum=2),
        "joint": dp_train_step(joint_model(joint_state), local, mesh,
                               joint=True),
        "eval": dp_eval_step(_unet(state, **kw), local, mesh),
    }


def trainer_and_cli(rank, world, root, conf_dirs, cli_args):
    """The trainer for one epoch over a data mesh on the cohort at
    ``root``, then the predict CLI with ``--window_parallel`` and with
    ``--data_parallel`` in the same world; which rank wrote what."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
        config as C)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data.pipeline import (
        create_brats_data_loaders)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
        cli)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
        UNet3D)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        batch_sharding, create_mesh)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
        checkpoints, trainer as T)
    mesh = create_mesh()
    train, val = create_brats_data_loaders(
        root, batch_size=2, num_workers=1, image_size=(16, 16, 16),
        device="cpu", sharding=batch_sharding(mesh))
    saves, writes = [], []
    save = checkpoints.save_checkpoint

    def counted_save(*a, **k):
        saves.append(a[0])
        return save(*a, **k)
    checkpoints.save_checkpoint = counted_save
    conf = C.Config(use_tensorboard=False, **conf_dirs)
    trainer = T.ModernBrainTumorTrainer(
        UNet3D(features=(8, 16), seed=0, device="cpu", dropout_rate=0.0,
               compute_dtype="float32"), config=conf,
        mesh=mesh, experiment_name="dp")
    hist = trainer.train(train, val, num_epochs=1)
    write = cli._write_outputs

    def counted_write(*a, **k):
        writes.append(a[1]["mask"])
        return write(*a, **k)
    cli._write_outputs = counted_write
    outs = {}
    for flag in ("--window_parallel", "--data_parallel"):
        mode = "cropped" if flag == "--window_parallel" else "whole_volume"
        outs[flag] = cli.predict_main(
            cli_args + [flag, "--mode", mode, "--output",
                        f"{conf_dirs['results_dir']}/pred{flag}"])
    return {"history": hist, "step": trainer.state.step, "saves": saves,
            "writes": writes, "summaries": outs,
            "rows": [int(b["image"].shape[0]) for b in train]}


# ---------------------------------------------------------------- space

def exchange_grads(rank, world, x, ws, cs):
    """The gradient with respect to this rank's D slab of ``x`` (float64)
    of ``sum(f(slab) * c_slab)`` over a (1, 2) mesh: ``f`` =
    ``sharded_conv3d`` of the 3x3x3 SAME conv (key "sharded"), and for
    each halo h and boundary b the VALID-in-D conv of
    ``halo_exchange_d(slab, h, group, b)`` (key f"{b}{h}")."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        mesh as M, spatial as S)
    m = M.create_mesh(1, 2)
    g = m.group("space")
    out = {}

    def grad(f, c):
        slab = M.shard_batch(torch.from_numpy(x), m).clone().requires_grad_()
        y = f(slab)
        (y * M.shard_batch(torch.from_numpy(c), m)).sum().backward()
        return _np(slab.grad)

    out["sharded"] = grad(S.sharded_conv3d(
        m, _ndhwc_conv(torch.from_numpy(ws[1]), 1)), cs["sharded"])
    for b in ("edge", "zero"):
        for h in (1, 2):
            # D extent 2h + 1, VALID in D: the slab extended by h planes
            conv = _ndhwc_conv(torch.from_numpy(ws[h]), (0, 1, 1))
            out[f"{b}{h}"] = grad(
                lambda s, h=h, b=b, conv=conv: conv(
                    S.halo_exchange_d(s, h, g, b)), cs[f"{b}{h}"])
    return out


def _refused(fn):
    """The exception ``fn()`` raises: (type name, message)."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def spatial_model(rank, world, state, joint_state, batch, vol):
    """On a (1, 2) mesh (this rank's D slab of ``batch``): the f32 train
    step (and with remat), the joint step, the eval step, the spatial
    sliding window, the slab forward's refusal, and the slab forwards
    that an earlier slice refused: the ps2d regions (features (32, 64),
    their wrappers counted) and deep heads at full resolution (features
    (8, 16, 32))."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.sliding_window import (
        sliding_window_inference)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
        UNet3D)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        create_mesh, make_spatial_apply, shard_batch)
    mesh = create_mesh(1, 2)
    g = mesh.group("space")
    local = shard_batch(batch, mesh)
    kw = dict(features=(8, 16), compute_dtype="float32", dropout_rate=0.0)
    out = {"mesh": dict(mesh.shape), "depth": local["image"].shape[1],
           "step": dp_train_step(_unet(state, **kw), local, mesh),
           "remat": dp_train_step(_unet(state, remat=True, **kw), local,
                                  mesh, config=_train_config(remat=True)),
           "joint": dp_train_step(joint_model(joint_state), local, mesh,
                                  joint=True),
           "eval": dp_eval_step(_unet(state, **kw), local, mesh)}
    with torch.no_grad():
        out["window"] = _np(sliding_window_inference(
            torch.from_numpy(vol), make_spatial_apply(_unet(state, **kw),
                                                      mesh),
            roi_size=(16, 16, 16), overlap=0.5, sw_batch_size=2))
    x = torch.from_numpy(local["image"])
    gen = torch.Generator().manual_seed(0)
    out["refusals"] = {
        "odd_depth": _refused(lambda: _unet(state, **kw).forward_train(
            x[:, :6], gen, space_group=g))}
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
        unet3d)
    calls = _counted(unet3d, REGION_KERNELS)
    wide = dict(kw, features=(32, 64))

    def ran(fn):
        calls.update({k: 0 for k in calls})
        o = fn()
        o = o if isinstance(o, dict) else {"logits": o, "deep": []}
        return {"logits": tuple(o["logits"].shape),
                "deep": [tuple(t.shape) for t in o["deep"]],
                "finite": bool(torch.isfinite(o["logits"]).all()),
                "calls": dict(calls)}
    out["runs"] = {
        "deep_sup_full_res": ran(lambda: UNet3D(
            device="cpu", deep_sup_full_res=True,
            **dict(kw, features=(8, 16, 32))).forward_train(
                x, gen, space_group=g)),
        "ps2d_train": ran(lambda: UNet3D(
            device="cpu", ps2d_train=True, **wide).forward_train(
                x, gen, space_group=g)),
        "ps2d_eval": ran(lambda: UNet3D(
            device="cpu", ps2d_eval=True, **wide)(x, space_group=g))}
    return out


def spatial_dp(rank, world, state, batch):
    """The f32 train step on a (2, 2) mesh: this rank's row and D slab."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        create_mesh, shard_batch)
    mesh = create_mesh(2, 2)
    local = shard_batch(batch, mesh)
    kw = dict(features=(8, 16), compute_dtype="float32", dropout_rate=0.0)
    return {"mesh": dict(mesh.shape), "coords": mesh.coords,
            "shape": tuple(local["image"].shape),
            "step": dp_train_step(_unet(state, **kw), local, mesh)}


def spatial_cli(rank, world, cwd, args, odd_args):
    """``train_main(args)`` (a ``--mesh_space 2`` run) in the working
    directory ``cwd``, then ``train_main(odd_args)``, whose slabs leave
    an odd depth: the first run's history, mesh and batch depth, and
    what the second raises."""
    import os
    os.chdir(cwd)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.cli import (
        train_main)
    trainer, hist = train_main(args)
    return {"history": hist, "mesh": dict(trainer.mesh.shape),
            "step": trainer.state.step,
            "odd": _refused(lambda: train_main(odd_args))}


def spatial_trainer(rank, world, root, conf_dirs):
    """The trainer for one epoch over a (1, 2) mesh on the cohort at
    ``root`` (each rank its D slab of every batch): its history, steps,
    checkpoint saves, final parameters and the batches' shapes."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
        config as C)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data.pipeline import (
        create_brats_data_loaders)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
        UNet3D)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        batch_sharding, create_mesh)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
        checkpoints, trainer as T)
    mesh = create_mesh(1, 2)
    train, val = create_brats_data_loaders(
        root, batch_size=2, num_workers=1, image_size=(16, 16, 16),
        device="cpu", sharding=batch_sharding(mesh))
    saves = []
    save = checkpoints.save_checkpoint

    def counted_save(*a, **k):
        saves.append(a[0])
        return save(*a, **k)
    checkpoints.save_checkpoint = counted_save
    trainer = T.ModernBrainTumorTrainer(
        UNet3D(features=(8, 16), seed=0, device="cpu", dropout_rate=0.0,
               compute_dtype="float32"),
        config=C.Config(use_tensorboard=False, **conf_dirs), mesh=mesh,
        experiment_name="sp")
    hist = trainer.train(train, val, num_epochs=1)
    return {"history": hist, "step": trainer.state.step, "saves": saves,
            "params": {n: _np(p) for n, p in
                       trainer.state.model.named_parameters()},
            "shapes": [tuple(b["image"].shape) for b in train]
            + [tuple(b["mask"].shape) for b in val]}


# ------------------------------------------------------- space: ps2d region

def _slab_of(t, rank, halo):
    """This rank's D slab of a (B, D, ...) numpy array over two ranks,
    ``halo`` planes of the array on each side (a halo-layout tensor's
    slab: its interior planes and the planes around them)."""
    d = (t.shape[1] - 2 * halo) // 2
    return torch.from_numpy(np.ascontiguousarray(
        t[:, d * rank:d * rank + d + 2 * halo]))


def ps2d_pieces(rank, world, d):
    """float64, on a (1, 2) mesh, this rank's D slab of each global
    array of ``d``: the halo-layout exchange's gradient, K1's plain
    version with live planes (two inputs, affine + ReLU + ``in_mul0`` +
    statistics) and K6's forward and gradients."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import (
        ps2d as T)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        create_mesh, spatial as S)
    mesh = create_mesh(1, 2)
    g = mesh.group("space")
    out = {}
    # 1. the exchange: a VALID conv of the exchanged slab of a halo
    # tensor (values everywhere, the halo too), garbage on the plane the
    # neighbour fills
    xh = _slab_of(d["xh"], rank, 1).requires_grad_()
    xg = xh.clone()
    xg[:, -1 if rank == 0 else 0] = 7.0
    y, out["live"] = S.halo_exchange_planes(xg, g)
    y = _ndhwc_conv(torch.from_numpy(d["w_x"]), 0)(y)
    (y * _slab_of(d["c_x"], rank, 0)).sum().backward()
    out["exchange"] = _np(xh.grad)
    # 2. K1's plain version on the exchanged slabs, each with a zero D
    # halo until the exchange fills it (the mask's 0.5, as psi has)
    def slab(k, fill):
        t = _slab_of(d[k], rank, 1).clone()
        t[:, [0, -1]] = fill
        return S.halo_exchange_planes(t, g)
    xs = [slab(k, 0.0)[0] for k in ("x0", "x1")]
    m, live = slab("mul0", 0.5)
    y, (s1, s2) = T.conv3d_halo(
        xs, torch.from_numpy(d["w1"]), in_scale=torch.from_numpy(d["scale"]),
        in_shift=torch.from_numpy(d["shift"]), in_relu=True, in_mul0=m,
        emit_stats=True, d_live=live)
    out["k1"] = (_np(y), _np(s1), _np(s2))
    # 3. K6 on the packed, exchanged slabs of two interiors
    leaves = [_slab_of(d[k], rank, 0).requires_grad_() for k in ("i0", "i1")]
    w6 = torch.from_numpy(d["w6"]).requires_grad_()
    hs, live = zip(*(S.halo_exchange_planes(T.pack_halo_plain(v), g)
                     for v in leaves))
    y = T.conv3d_halo_train(hs, w6, live[0])
    (y * _slab_of(d["c6"], rank, 1)).sum().backward()
    out["k6"] = (_np(y), *(_np(v.grad) for v in leaves), _np(w6.grad))
    return out


def _counted(module, names):
    """Replace each function ``names`` of ``module`` by one that counts
    its calls; the counts, by name."""
    calls = {}
    for name in names:
        fn = getattr(module, name)

        def wrapper(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        setattr(module, name, wrapper)
        calls[name] = 0
    return calls


REGION_KERNELS = ("conv3d_halo", "up_k2s2_into_halo", "pack_halo",
                  "pool_into_halo", "conv3d_halo_train")


def spatial_ps2d_train(rank, world, d):
    """On a (1, 2) mesh, this rank's D slab of ``d["batch"]``: the
    ``ps2d_train`` step in f32 and in bf16 at features (32, 64), with the
    region's wrapper calls counted."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
        unet3d)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        create_mesh, shard_batch)
    mesh = create_mesh(1, 2)
    local = shard_batch(d["batch"], mesh)
    calls = _counted(unet3d, REGION_KERNELS)
    out = {"depth": local["image"].shape[1]}
    for dt in ("float32", "bfloat16"):
        model = _unet(d["state"], features=(32, 64), ps2d_train=True,
                      dropout_rate=0.0, compute_dtype=dt)
        out[dt] = dp_train_step(model, local, mesh)
        out[dt]["calls"] = dict(calls)
        calls.update({k: 0 for k in calls})
    return out


def spatial_ps2d_eval(rank, world, d):
    """On a (1, 2) mesh: the eval forward of ``d["wins"]`` at
    ``ps2d_eval, ps2d_levels=2`` (features (32, 64)) through
    ``make_spatial_apply``, the region's wrapper calls counted, and the
    ``deep_sup_full_res`` train step at features (8, 16, 32) on this
    rank's D slab of ``d["batch"]``."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
        unet3d)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        create_mesh, make_spatial_apply, shard_batch)
    mesh = create_mesh(1, 2)
    calls = _counted(unet3d, REGION_KERNELS)
    model = _unet(d["state"], features=(32, 64), ps2d_eval=True,
                  ps2d_levels=2, compute_dtype="float32")
    with torch.no_grad():
        out = {"eval": _np(make_spatial_apply(model, mesh)(
            torch.from_numpy(d["wins"])))}
    out["eval_calls"] = dict(calls)
    out["deep"] = dp_train_step(
        _unet(d["deep_state"], features=(8, 16, 32), deep_sup_full_res=True,
              dropout_rate=0.0, compute_dtype="float32"),
        shard_batch(d["batch"], mesh), mesh)
    return out


def loss3d_slabs(rank, world, logits, targets):
    """``boundary_loss`` and ``combined_loss3d`` over a (1, 2) mesh on this
    rank's D slab of ``logits`` (float32) and ``targets``: each loss's
    value (and ``combined_loss3d``'s parts) and its gradient with respect
    to the slab."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
        losses as L)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
        mesh as M)
    m = M.create_mesh(1, 2)
    g = m.group("space")
    tg = M.shard_batch(torch.from_numpy(targets), m)
    out = {}
    for name in ("boundary", "combined3d"):
        lg = M.shard_batch(torch.from_numpy(logits), m).clone()
        lg.requires_grad_()
        if name == "boundary":
            loss, parts = L.boundary_loss(lg, tg, group=g), {}
        else:
            loss, parts = L.combined_loss3d(lg, tg, group=g)
        loss.backward()
        out[name] = (float(loss), {k: float(v) for k, v in parts.items()},
                     _np(lg.grad))
    return out
