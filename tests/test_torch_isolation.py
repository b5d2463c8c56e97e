"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its scheduler refuses to fall back to the CPU on its own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "kubernetes_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(PORT):
        files.extend(os.path.join(d, n) for n in names if n.endswith(".py"))
    return sorted(files)


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import kubernetes_tpu_torch.scheduler\n"
            "import kubernetes_tpu_torch.ops.kernels\n"
            "import kubernetes_tpu_torch.parallel.sharding\n"
            "import kubernetes_tpu_torch.state.convert\n"
            "import kubernetes_tpu_torch.obs.explain\n"
            "import kubernetes_tpu_torch.perf.harness\n"
            "import kubernetes_tpu_torch.utils.runtime\n"
            "import kubernetes_tpu_torch.utils.tracing\n"
            "import kubernetes_tpu_torch.config\n"
            "import kubernetes_tpu_torch.config.features\n"
            "import kubernetes_tpu_torch.analysis\n"
            "import kubernetes_tpu_torch.analysis.__main__\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'kubernetes_tpu' "
            "or m.startswith('kubernetes_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "kubernetes_tpu"), (
                f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {name}")


def test_scheduler_defaults_to_cuda_and_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from kubernetes_tpu_torch.backend.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import Scheduler
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Scheduler(APIServer())
    sched = Scheduler(APIServer(), device="cpu")
    assert sched.device.type == "cpu"


def test_kernel_wrappers_refuse_non_cuda_devices():
    from kubernetes_tpu_torch.ops import program
    from kubernetes_tpu_torch.state.convert import node_arrays_from_numpy
    from kubernetes_tpu_torch.state.tensorize import Dims, _zero_arrays
    na = node_arrays_from_numpy(_zero_arrays(Dims()), "meta")
    carry = program.initial_carry(na)
    with pytest.raises(RuntimeError, match="unsupported device"):
        program.run_batch(program.ScoreConfig(), na, carry,
                          program.PodXs(None, None, None), None)


def test_harness_import_needs_no_yaml():
    """The card's machine has no pyyaml: importing the harness (as
    chip_smoke does) must not import it; only load_test_cases does."""
    code = ("import sys\n"
            "import kubernetes_tpu_torch.perf.harness\n"
            "assert 'yaml' not in sys.modules\n"
            "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


@pytest.mark.parametrize("wrapper,args", [
    ("cluster_probe", lambda P, na, carry: (na, carry, None, 1)),
    ("explain_row", lambda P, na, carry: (P.ScoreConfig(), na, carry, None,
                                          0, 1)),
])
def test_new_kernel_wrappers_refuse_non_cuda_devices(wrapper, args):
    from kubernetes_tpu_torch.ops import program
    from kubernetes_tpu_torch.state.convert import node_arrays_from_numpy
    from kubernetes_tpu_torch.state.tensorize import Dims, _zero_arrays
    na = node_arrays_from_numpy(_zero_arrays(Dims()), "meta")
    carry = program.initial_carry(na)
    with pytest.raises(RuntimeError, match="unsupported device"):
        getattr(program, wrapper)(*args(program, na, carry))


CSRC = os.path.join(PORT, "csrc")


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(CSRC)
                                        if f.endswith(".cu")))
def test_kernel_source_stands_alone(name):
    """Every kernel source is one the wrappers build (ops/kernels.py
    SOURCES), has a plain C interface and no PyTorch header, and names
    the JAX program it replaces and what bounds it on an H100."""
    from kubernetes_tpu_torch.ops.kernels import SOURCES
    text = open(os.path.join(CSRC, name)).read()
    assert name[:-3] in SOURCES
    assert 'extern "C"' in text
    assert "#include <torch" not in text and "#include <ATen" not in text
    assert "kubernetes_tpu/" in text
    assert "What bounds it on an H100" in text
