"""The check of loaded modules compares whole top-level names."""
from benchmark.harness.imports import forbidden


def test_the_port_passes():
    assert forbidden(["qtpu_torch", "qtpu_torch.x", "torch", "numpy"]) == []


def test_the_jax_package_and_jax_fail():
    assert forbidden(["qtpu.x"]) == ["qtpu"]
    assert forbidden(["jax"]) == ["jax"]
    assert forbidden(["jaxlib.xla", "flax.linen", "qtpu_torch"]) == [
        "flax", "jaxlib"]


def test_the_harness_and_the_reference_load_no_forbidden_module():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.harness.runner, benchmark.reference.pipeline;"
            "from benchmark.harness.imports import forbidden;"
            "print(forbidden(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=__file__.rsplit("/benchmark/", 1)[0])
    assert out.stdout.strip() == "[]"
