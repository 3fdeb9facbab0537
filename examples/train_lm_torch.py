"""End to end on the H100 port: train xlstm-125m for a few hundred steps
(the PyTorch counterpart of ``examples/train_lm.py``).

Uses the port's whole trainer: the token pipeline, the microbatched and
rematerialized train step (every forward product through the ``linear``
kernel on the card, the mLSTM and sLSTM recurrences in plain float32
torch), AdamW, checkpoints with retention and ``--resume auto``, the
straggler monitor: 8 x 128 tokens a step in 2 microbatches, lr 3e-3, a
checkpoint every 50 steps.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --smoke --device cpu \\
        --steps 20 --ckpt-dir /tmp/ck

Without ``--smoke`` it trains the published xlstm-125m config (12
layers, d 768); ``--smoke`` takes the reduced config the JAX example
trains by default.  ``--device cpu`` runs the plain PyTorch versions.
"""
import argparse

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced xlstm-125m config")
    ap.add_argument("--ckpt-dir", default="build/train_lm_torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    train_argv = [
        "--arch", "xlstm-125m",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--microbatches", "2",
        "--lr", "3e-3",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
        "--resume", "auto",
        "--device", args.device,
    ]
    if args.smoke:
        train_argv.append("--smoke")
    losses = train_main(train_argv)
    if losses:
        print(f"final loss {losses[-1]:.4f} over {len(losses)} steps "
              f"(checkpoints in {args.ckpt_dir})")
    else:
        print(f"already at step {args.steps} (checkpoints in "
              f"{args.ckpt_dir})")


if __name__ == "__main__":
    main()
