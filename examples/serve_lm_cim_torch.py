"""End-to-end LM serving on the port: batched requests through a
smolLM-architecture model (reduced), standard execution against NeuDW-CIM
mode (ternary twin-cell weights + NLQ activations on every projection).
The counterpart of ``examples/serve_lm_cim.py`` over
``repro_torch.launch.serve``; the prefill attention is the flash kernel.

    python examples/serve_lm_cim_torch.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv=None):
    extra = list(argv if argv is not None else sys.argv[1:])
    base = ["--arch", "smollm-135m", "--smoke", "--requests", "6",
            "--slots", "3", "--max-new", "8"] + extra
    print("== standard execution ==")
    serve.main(base)
    print("\n== NeuDW-CIM mode (ternary weights + NLQ activations) ==")
    serve.main(base + ["--cim"])


if __name__ == "__main__":
    main()
