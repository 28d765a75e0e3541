"""GPipe in the port (``repro_torch.dist.pipeline``) against the JAX
package's on two stages.

The reference runs ``gpipe`` on 2 simulated host devices as
``tests/test_pipeline.py`` sets it up, on operands drawn from
``numpy.random.RandomState``; the port on 2 gloo ranks
(``tests/_dist_ranks_torch.py gpipe``), each holding its stage's slice,
the activations sent on a ``batch_isend_irecv`` ring.  The outputs agree
within 1e-5 and equal the stages run in sequence; ``bubble_fraction``
equals the reference's.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.dist import pipeline as j_pipeline
from repro_torch.dist import pipeline as t_pipeline

ROOT = Path(__file__).resolve().parent.parent

_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro import compat
    from repro.dist.pipeline import gpipe

    mesh = compat.make_mesh((2,), ("pod",))
    rs = np.random.RandomState(0)
    D = 8
    w = (rs.normal(size=(2, D, D)) / np.sqrt(D)).astype(np.float32)
    x_mb = rs.normal(size=(4, 3, D)).astype(np.float32)
    y = jax.jit(lambda p, x: gpipe(lambda p, x: jnp.tanh(x @ p["w"]),
                                   p, x, mesh))({"w": w}, x_mb)
    ref = x_mb
    for s in range(2):
        ref = np.tanh(ref @ w[s])
    np.savez(sys.argv[1], **{"in/params/w": w, "in/x_mb": x_mb,
                            "out/y": np.asarray(y), "out/sequential": ref})
""")


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, *map(str, args)], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpipe")
    ref, port = d / "ref.npz", d / "port.npz"
    _run(["-c", _JAX, ref], timeout=300)
    _run([ROOT / "tests" / "_dist_ranks_torch.py", "gpipe", ref, port],
         timeout=300)
    with np.load(ref) as r, np.load(port) as t:
        yield dict(r), dict(t)


def test_gpipe_matches_jax_gpipe(results):
    want, got = results
    np.testing.assert_allclose(got["out/y"], want["out/y"], rtol=1e-5,
                               atol=1e-5)
    assert float(got["rank_spread/out/y"]) == 0.0


def test_gpipe_equals_the_stages_in_sequence(results):
    want, got = results
    np.testing.assert_allclose(got["out/y"], want["out/sequential"],
                               rtol=1e-5, atol=1e-5)
    assert float(got["out/bubble"]) == j_pipeline.bubble_fraction(4, 2)


@pytest.mark.parametrize("n_micro", [1, 4, 8, 31])
@pytest.mark.parametrize("n_stages", [1, 2, 4, 16])
def test_bubble_fraction_equals_reference(n_micro, n_stages):
    assert t_pipeline.bubble_fraction(n_micro, n_stages) == \
        j_pipeline.bubble_fraction(n_micro, n_stages)
