"""Training entry point, the twin of the repository's ``train.py``: the
epoch loop with one ``Trainer.step`` per batch (metrics fetched one step
late, so the card runs ahead of the host), validation every
``val_interval`` epochs capped at 30 batches, the plateau lr schedule,
best-val-gated checkpoints (or ``always_save``) with the reconstruction
gallery, ``latest_interval`` resume points, ``loss_log.txt`` and
``metrics.jsonl``; a LocalEnhancer's global trunk stays frozen for the
first ``model.niter_fix_global`` epochs, a resumed run included
(``Trainer.maybe_unfreeze_global`` at the top of each epoch).
``optim.max_host_rss_gb`` chunks a run by host memory: after an epoch
whose end finds the process's resident memory above the limit, the exact state is saved to ``save_dir/latest`` (unless the epoch
saved already) and the process exits with code 75, for a wrapper loop to
start it again with ``--load_model --checkpoints_dir <save_dir>``, which
resumes from ``latest``.

    python -m jpdse_tpu_torch.train --dataset cityscapes --root_dir DATA \\
        --preprocess_mode fixed --load_size 1024 --crop_size 1024 \\
        --normalize_std 1 --batch_size 2 --remat 1 --save_dir runs/x

Batches reach the card through ``data/prefetch.py::prefetch_to_device``
(two placed ahead, on a side stream). Under ``cache_images`` with
``data.device_cache`` (the default) the training set is resident on the
card and each batch is assembled there from the loader's (index, flip)
(``data/device_cache.py``), and the validation batches are placed once and
replayed; otherwise the loader's host batches are copied. With
``profile_dir`` the first trained epoch runs under a ``torch.profiler``
trace written there (``utils/profiling.py``).

Under a process group (``JPDSE_COORDINATOR`` / ``JPDSE_NUM_PROCESSES`` /
``JPDSE_PROCESS_ID``, or ``torchrun``; ``parallel/distributed.py``) each
process trains on its rank's shard with ``batch_size`` images a step, the
gradients all-reduced (``train/step.py``); every rank validates the same
unsharded set, so the plateau schedule decides alike everywhere; rank 0
alone writes (``opt.json``, the logs, the gallery, the checkpoints), every
rank restores; ``max_host_rss_gb`` acts only in a single process, as in
JAX (``train.py:257-262``); and the run ends at a barrier.

    torchrun --nproc_per_node 2 -m jpdse_tpu_torch.train [flags]

Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from jpdse_tpu_torch.cli import parse_config, print_config
from jpdse_tpu_torch.config import derive_eval_config
from jpdse_tpu_torch.data import create_dataloader
from jpdse_tpu_torch.data.device_cache import maybe_device_cache, maybe_val_cache
from jpdse_tpu_torch.data.prefetch import prefetch_to_device
from jpdse_tpu_torch.parallel import distributed
from jpdse_tpu_torch.platform import init_distributed, resolve_device
from jpdse_tpu_torch.trainer import Trainer
from jpdse_tpu_torch.utils.logging import MetricsLogger
from jpdse_tpu_torch.utils.profiling import trace
from jpdse_tpu_torch.utils.visualizer import HTMLGallery, Visualizer

MAX_VAL_SIZE = 30  # reference train.py:16
EXIT_RESTART = 75  # the exit code of a run chunked by host memory


def host_rss_gb() -> float:
    """This process's resident memory (VmRSS) in GiB; 0 where the status
    lists none."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1048576
    return 0.0


def log(msg: str, log_file: Optional[str] = None):
    print(msg)
    if log_file:
        with open(log_file, "a") as f:
            print(msg, file=f)


def validate(trainer: Trainer, val_loader, log_file, cfg) -> float:
    print("\nvalidating...\n")
    total, n = 0.0, 0
    start = time.time()
    for i, batch in enumerate(val_loader):
        if i == MAX_VAL_SIZE:
            break
        loss = trainer.get_eval_loss(batch)
        total += loss
        n += 1
        end = time.time()
        print(f"batch {i + 1}/{len(val_loader)}, distortion ({cfg.loss.distortion_loss_fn}) "
              f"{loss:.4f}, batch processing time (s) {end - start:.4f}")
        start = time.time()
    avg = total / max(n, 1)
    log(f"val set avg distortion ({cfg.loss.distortion_loss_fn}) {avg:.4f}", log_file)
    return avg


def _host(v):
    """A batch field as numpy (a placed validation batch holds tensors)."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


def dump_reconstructions(trainer: Trainer, val_loader, cfg, gallery, visualizer):
    print("\nsaving reconstructed val images...\n")
    limit = cfg.max_recon_dump  # None: every image of the (<= 30-batch) val pass
    n_dumped = 0
    for i, batch in enumerate(val_loader):
        if i == MAX_VAL_SIZE or (limit is not None and n_dumped >= limit):
            break
        n_dumped += batch["image"].shape[0]
        recon = trainer.get_img(batch).cpu().numpy()
        if gallery is None:  # a rank other than 0
            continue
        for j in range(recon.shape[0]):
            visuals = {}
            if not cfg.model.no_label:
                visuals["label"] = _host(batch["label"][j])
            visuals["image"] = _host(batch["image"][j])
            visuals["reconstructed_image"] = recon[j]
            visualizer.save_images(gallery, visuals, batch["path"][j])
        gallery.save()


def run_epoch(trainer: Trainer, loader, cfg, epoch: int, metrics_log, log_file,
              dev_cache=None):
    """One pass over the loader, its batches placed two ahead
    (``prefetch_to_device``; by the device cache from meta batches where
    there is one); each step's metrics are fetched after the next step is
    queued, and the logged batch time is the interval between two fetches
    (load, launch and the card's work). The epoch ends with the host-clock
    time it waited for the loader and the placement, of its whole time:
    what the data pipeline (a base codec's encodes among it) did not
    hide."""
    place = trainer.place if dev_cache is None else dev_cache.place
    batches = prefetch_to_device(loader, size=2, device=trainer.device, place_fn=place)
    steps0 = trainer.steps_taken
    n_batches = len(loader)
    pending = None
    t_prev = time.time()

    def flush(item):
        nonlocal t_prev
        i, handle = item
        metrics = trainer.fetch_metrics(handle)
        now = time.time()
        dt, t_prev = now - t_prev, now
        metrics_log.log(steps0 + i + 1, metrics, epoch=epoch)
        print("g_gan: {G_GAN:.4f}, g_gan_feat_match: {G_GAN_Feat:.4f}, g_vgg: {G_VGG:.4f}, "
              "g_distortion: {G_Distortion:.4f}, d_real: {D_real:.4f}, "
              "d_fake: {D_fake:.4f}".format(**metrics))
        log(f"epoch {epoch + 1}/{trainer.start_epoch + cfg.optim.num_epochs}, batch "
            f"{i + 1}/{n_batches}, distortion ({cfg.loss.distortion_loss_fn}) "
            f"{metrics['G_Distortion']:.4f}, batch processing time (s) {dt:.4f}", log_file)

    t_epoch = t_asked = time.perf_counter()
    wait = 0.0
    for i, batch in enumerate(batches):
        wait += time.perf_counter() - t_asked
        handle = trainer.step_async(batch)
        if pending is not None:
            flush(pending)
        pending = (i, handle)
        t_asked = time.perf_counter()
    if pending is not None:
        flush(pending)
    log(f"epoch {epoch + 1}: loader wait {wait:.4f} s of {time.perf_counter() - t_epoch:.4f} s",
        log_file)


def main(argv: Optional[List[str]] = None, device="cuda") -> Trainer:
    init_distributed(device)
    device = resolve_device(device)
    is_main = distributed.is_main()
    cfg = parse_config(argv, is_train=True)
    val_cfg = derive_eval_config(cfg, mode="val")
    print("\ntrain options:\n")
    print_config(cfg)
    if cfg.optim.seed is not None:
        np.random.seed(cfg.optim.seed)
    if cfg.save_dir and is_main:
        os.makedirs(cfg.save_dir, exist_ok=True)
        cfg.save(os.path.join(cfg.save_dir, "opt.json"))

    loader = create_dataloader(cfg)
    val_loader = create_dataloader(val_cfg)
    visualizer = Visualizer(cfg)
    gallery = (HTMLGallery(os.path.join(cfg.save_dir, "train_visualizations"), "visualizations")
               if is_main else None)

    trainer = Trainer(cfg, mode="train", device=device)
    n_params = sum(p.numel() for p in trainer.gan.codec.parameters())
    print(f"# trainable params at initialization: {n_params}")
    log_file = os.path.join(cfg.save_dir, "loss_log.txt") if cfg.save_dir and is_main else None
    metrics_log = MetricsLogger(cfg.save_dir if is_main else None)
    dev_cache = maybe_device_cache(loader, cfg, trainer.device, mesh=trainer.mesh)
    if dev_cache is not None:
        loader.meta_only = True
    val_batches = maybe_val_cache(val_loader, cfg, trainer.device, cap=MAX_VAL_SIZE,
                                  mesh=trainer.mesh) or val_loader

    if cfg.load_model:
        trainer.load()
        validate(trainer, val_batches, log_file, cfg)  # confirms the load

    for epoch in range(trainer.start_epoch, trainer.start_epoch + cfg.optim.num_epochs):
        trainer.maybe_unfreeze_global(epoch)
        loader.set_epoch(epoch)
        # a profiler trace of the first trained epoch, when asked
        first = epoch == trainer.start_epoch
        with trace(cfg.profile_dir if first else None):
            run_epoch(trainer, loader, cfg, epoch, metrics_log, log_file, dev_cache)

        saved = False
        if not (epoch + 1) % cfg.optim.val_interval:
            avg = validate(trainer, val_batches, log_file, cfg)
            if cfg.optim.schedule_lr:
                trainer.scheduler_step(avg)
            metrics_log.log(trainer.steps_taken,
                            {"avg_val_distortion": avg, "lr": trainer.current_lr}, epoch=epoch)
            if cfg.always_save or (avg < trainer.best_val_loss and cfg.save_dir):
                # under the spatial axis every rank decodes its rows; rank 0 writes
                if is_main or trainer.mesh.spatial > 1:
                    dump_reconstructions(trainer, val_batches, cfg, gallery, visualizer)
                log("saving model...", log_file)
                trainer.save(epoch, avg)
                saved = True

        if (cfg.optim.latest_interval and cfg.save_dir and not saved
                and not (epoch + 1) % cfg.optim.latest_interval):
            trainer.save_latest(epoch)
            saved = True

        if cfg.optim.max_host_rss_gb and cfg.save_dir and distributed.world() == 1 and \
                host_rss_gb() > cfg.optim.max_host_rss_gb:  # a per-process decision and exit
            log(f"host RSS {host_rss_gb():.1f}GB > --max_host_rss_gb "
                f"{cfg.optim.max_host_rss_gb}; saving latest state and exiting "
                f"{EXIT_RESTART} for a wrapper restart", log_file)
            if not saved:  # this epoch's save serves as the resume point
                trainer.save_latest(epoch)
            raise SystemExit(EXIT_RESTART)
    distributed.barrier()  # no rank leaves while another still writes
    return trainer


if __name__ == "__main__":
    main()
