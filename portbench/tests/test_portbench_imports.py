"""The run's check for JAX compares whole top-level module names."""

import pytest

from portbench import run


@pytest.mark.parametrize("name,found", [
    ("jax", ["jax"]),
    ("jax.numpy", ["jax"]),
    ("jaxlib.xla_client", ["jaxlib"]),
    ("flax.linen", ["flax"]),
    ("kafkabalancer_tpu", ["kafkabalancer_tpu"]),
    ("kafkabalancer_tpu.cli", ["kafkabalancer_tpu"]),
    ("kafkabalancer_tpu_torch", []),
    ("kafkabalancer_tpu_torch.serve.daemon", []),
    ("jaxtyping", []),
])
def test_whole_top_level_names(name, found):
    assert run.forbidden_modules([name, "json", "torch"]) == found


def test_the_harness_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.'); "
            "import portbench.run, portbench.server, portbench.devtrace, "
            "portbench.load, portbench.correct; "
            "import kafkabalancer_tpu_torch.cli, "
            "kafkabalancer_tpu_torch.serve.daemon; "
            "print(portbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=run.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
