"""Training driver: ``python -m repro_torch.launch.train --arch <id>``.

Runs ``Trainer.fit`` on the synthetic data stream, on the card unless
``--device cpu`` is given, on the reduced config unless ``--full``:
checkpoint/restart fault tolerance and straggler monitoring as the
reference's driver, with its flags and its log lines.  With
``--grad-accum N`` each batch is cut into N micro-batches along a new
leading axis, the layout ``Trainer`` takes for accumulation.
"""
from __future__ import annotations

import argparse

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.distribution.elastic import StragglerMonitor
from repro_torch.training import TrainConfig, Trainer
from repro_torch.training.data import DataConfig, Prefetcher, synthetic_stream


def micro_batches(stream, accum: int):
    """Each batch of ``stream`` as ``accum`` micro-batches stacked on a
    leading axis: (b, ...) -> (accum, b / accum, ...)."""
    for batch in stream:
        yield {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in batch.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4_mini_3p8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.grad_accum > 1 and args.batch % args.grad_accum:
        ap.error(f"--batch {args.batch} is not a multiple of --grad-accum {args.grad_accum}")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    tcfg = TrainConfig(
        steps=args.steps,
        checkpoint_dir=args.checkpoint_dir,
        grad_accum=args.grad_accum,
    )
    trainer = Trainer(cfg, tcfg, device=dev)
    resumed = trainer.restore_if_available()
    if resumed:
        print(f"[train] resumed from step {trainer.step}")

    dcfg = DataConfig(batch=args.batch, seq_len=args.seq_len)
    stream = synthetic_stream(cfg, dcfg, start_step=trainer.step, device=dev)
    if args.grad_accum > 1:
        stream = micro_batches(stream, args.grad_accum)
    data = Prefetcher(stream)
    mon = StragglerMonitor()

    def log(rec):
        strag = mon.observe(rec["step"], rec["dt_s"])
        print(
            f"[train] step {rec['step']:5d} loss={rec['loss']:.4f} "
            f"gnorm={rec['grad_norm']:.3f} dt={rec['dt_s']*1e3:.0f}ms"
            + ("  STRAGGLER", "")[not strag]
        )

    result = trainer.fit(data, on_log=log)
    data.close()
    print(f"[train] done at step {result['final_step']}")


if __name__ == "__main__":
    main()
