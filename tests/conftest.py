import os

# Tests run on a virtual 8-device CPU mesh so the sharded paths are
# exercised without an accelerator.  The platform is pinned before any
# backend initializes.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import su2_tpu  # noqa: E402,F401  (sets the persistent compilation cache)

# the suite is compile-bound: cache every compiled program, however quick
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
assert jax.devices()[0].platform == "cpu"

import pytest  # noqa: E402


REF_ROOT = "/root/reference/Test_Cases/TURBOLENT"


def _reference_case(name):
    path = os.path.join(REF_ROOT, name)
    if not os.path.isdir(path):
        pytest.skip(f"reference test case {name} not present "
                    f"(expected under {REF_ROOT})")
    return path


@pytest.fixture(scope="session")
def combustion_dir():
    """The fork's shipped combustion case (mesh, cfgs, chemistry)."""
    return _reference_case("TURBOLENT_COMBUSTION")


@pytest.fixture(scope="session")
def flatplate_dir():
    """The fork's shipped turbulent flat-plate case."""
    return _reference_case("TURBOLENT_FLAT_PLATE")


@pytest.fixture(scope="session")
def standin_dir(tmp_path_factory):
    """The in-repo stand-in for the flagship combustor (su2_tpu.testcase)
    at a test size: 33 x 17 nodes, seed 0."""
    from su2_tpu import testcase
    d = tmp_path_factory.mktemp("standin")
    testcase.write_case(str(d), nx=33, ny=17, seed=0, niter=4)
    return str(d)


@pytest.fixture(scope="session")
def standin_lib(standin_dir):
    """The stand-in's 9-species chemistry library (float64)."""
    from su2_tpu.chemistry import library as cl
    return cl.load_library(os.path.join(standin_dir, "library.txt"))
