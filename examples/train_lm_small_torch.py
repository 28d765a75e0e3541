"""Small-LM training end to end on the port: the loss decreases,
checkpoints are written, and a restart resumes from them (the train
driver on a reduced smolLM config).  The counterpart of
``examples/train_lm_small.py`` over ``repro_torch.launch.train``.

    python examples/train_lm_small_torch.py [--device cpu]
"""

import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import train  # noqa: E402


def main(argv=None):
    extra = list(argv if argv is not None else sys.argv[1:])
    ckpt = tempfile.mkdtemp(prefix="repro_torch_example_ckpt_")
    base = ["--arch", "smollm-135m", "--smoke", "--global-batch", "8",
            "--seq-len", "64", "--n-micro", "2", "--ckpt-dir", ckpt,
            "--lr", "5e-3"] + extra
    try:
        history = train.main(base + ["--steps", "12", "--ckpt-every", "6"])
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"\nloss {first:.3f} -> {last:.3f} "
              f"({'DECREASED' if last < first else 'did not decrease'})")
        print("resuming from checkpoint for 4 more steps...")
        train.main(base + ["--steps", "16", "--ckpt-every", "8"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
