"""The port's example entry points (medgp_tpu_torch/examples/) against the
JAX package's (examples/), on the CPU.

  * every script parses (`bash -n`), and the configs are byte copies of
    the JAX package's;
  * the command line each shell script runs (caught by a stand-in
    $PYTHON) is `-m medgp_tpu_torch.cli.main` and argv that the port's CLI
    parser accepts, with the script's settings and the caller's extra
    arguments (`--device cpu`);
  * `launch_pod.py --emit-slurm` writes a Slurm script that starts
    `torchrun` of `medgp_tpu_torch.cli.main run` on every host; without a
    card `launch_pod.py` stops and names `--device cpu`; with it, it calls
    the CLI's `run` on the CPU;
  * both packages' `gen_example.sh` on the same synthetic DATA_ROOT write
    the same exp_setup.json apart from paths, and the same CV assignment
    and hyper bounds.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from medgp_tpu_torch.cli.main import build_parser  # noqa: E402
from medgp_tpu_torch.data.synthetic import (  # noqa: E402
    sample_cohort, write_reference_format_cohort,
)
from medgp_tpu_torch.models.params import LMCSMSpec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "medgp_tpu_torch", "examples")
JAX = os.path.join(REPO, "examples")
SCRIPTS = ("gen_example.sh", "run_pipeline.sh", "train_large_patient.sh")
CONFIGS = ("feature_all.json", "feature_PT_INR.json", "opt_prior0.json", "opt_prior2.json")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_parse(name):
    subprocess.run(["bash", "-n", os.path.join(PORT, name)], check=True)
    assert os.access(os.path.join(PORT, name), os.X_OK)


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_are_copies(name):
    with open(os.path.join(PORT, name), "rb") as a, open(os.path.join(JAX, name), "rb") as b:
        assert a.read() == b.read()


def _argv(tmp_path, script, *args, **env):
    """The argv a script hands to $PYTHON, caught by a stand-in that writes
    it out."""
    out = tmp_path / f"{script}.argv"
    stub = tmp_path / "python"
    stub.write_text('#!/bin/bash\nprintf "%s\\0" "$@" > "$ARGV_OUT"\n')
    stub.chmod(0o755)
    subprocess.run(["bash", os.path.join(PORT, script), *args], check=True,
                   env=_env(PYTHON=str(stub), ARGV_OUT=str(out), **env))
    argv = out.read_text().split("\0")[:-1]
    assert argv[:2] == ["-m", "medgp_tpu_torch.cli.main"]
    return build_parser().parse_args(argv[2:])


def test_script_command_lines_parse(tmp_path):
    a = _argv(tmp_path, "run_pipeline.sh", "/x/exp_setup.json", "--device", "cpu",
              "--sampler", "hmc")
    assert (a.command, a.cfg, a.alg, a.device, a.sampler) == (
        "run", "/x/exp_setup.json", "gmm", "cpu", "hmc")
    a = _argv(tmp_path, "run_pipeline.sh", "/x/exp_setup.json")
    assert (a.command, a.device) == ("run", None)  # the CLI's default: the card
    a = _argv(tmp_path, "train_large_patient.sh", "/x/exp_setup.json")
    assert (a.command, a.large_threshold, a.restarts, a.device) == ("train", 8192, 64, None)
    a = _argv(tmp_path, "train_large_patient.sh", "/x/exp_setup.json", "1000", "--device", "cpu")
    assert (a.large_threshold, a.restarts, a.device) == (1000, 64, "cpu")
    a = _argv(tmp_path, "gen_example.sh", DATA_ROOT="/d", EXP_ROOT="/e")
    assert (a.command, a.data_root, a.exp_root, a.cohort, a.kernel, a.prior) == (
        "generate", "/d", "/e", "heart_failure", "LMC-SM", "hier-gamma")
    assert (a.Q, a.R, a.eta, a.beta_lam, a.cv_fold_num, a.cv_seed, a.exp_prefix) == (
        5, 8, 0.01, 0.01, 10, 718, "jmlr")
    assert a.feature_config.endswith("medgp_tpu_torch/examples/feature_all.json")
    assert a.opt_config.endswith("medgp_tpu_torch/examples/opt_prior2.json")


def _launch_pod():
    """examples/launch_pod.py of the port as a module."""
    spec = importlib.util.spec_from_file_location("launch_pod", os.path.join(PORT, "launch_pod.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launch_pod_emits_slurm(tmp_path, capsys):
    path = tmp_path / "pod.sh"
    _launch_pod().main(["--cfg", "/x/exp_setup.json", "--emit-slurm", str(path),
                        "--num-hosts", "2", "--gpus-per-host", "8"])
    assert capsys.readouterr().out.strip() == str(path)
    text = path.read_text()
    subprocess.run(["bash", "-n", str(path)], check=True)
    assert "#SBATCH -N 2" in text and "#SBATCH --gpus-per-node=8" in text
    (run,) = [x for x in text.splitlines() if x.startswith("srun torchrun ")]
    assert "--nnodes 2 --nproc-per-node 8" in run
    assert "-m medgp_tpu_torch.cli.main run --cfg /x/exp_setup.json --alg gmm" in run


def test_launch_pod_needs_a_card_or_cpu(monkeypatch):
    """Without a card it stops and names --device cpu; with --device cpu
    it hands the CLI `run` the config, the algorithm and the device."""
    mod = _launch_pod()
    calls = []
    import medgp_tpu_torch.cli.main as cli

    monkeypatch.setattr(cli, "main", calls.append)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="pass --device cpu"):
            mod.main(["--cfg", "/x/exp_setup.json"])
        assert calls == []
    mod.main(["--cfg", "/x/exp_setup.json", "--device", "cpu"])
    assert calls == [["run", "--cfg", "/x/exp_setup.json", "--alg", "gmm", "--device", "cpu"]]


def test_gen_example_writes_what_jax_writes(tmp_path):
    """Both packages' gen_example.sh on one synthetic heart_failure cohort
    of 6 patients over feature_all.json's 24 features."""
    with open(os.path.join(PORT, "feature_all.json")) as f:
        features = [x["index"] for x in json.load(f)["feature_list"]]
    recs = sample_cohort(3, LMCSMSpec(1, len(features), 1), 6, n_obs_range=(50, 70))
    data = tmp_path / "data"
    write_reference_format_cohort(str(data / "heart_failure"), recs, features)
    tops = {}
    for pkg, here, py in (("jax", JAX, "python"), ("port", PORT, sys.executable)):
        exp = tmp_path / f"exp_{pkg}"
        env = _env(DATA_ROOT=str(data), EXP_ROOT=str(exp), PYTHON=py,
                   PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"])
        subprocess.run(["bash", os.path.join(here, "gen_example.sh")], check=True, env=env,
                       capture_output=True, cwd=str(tmp_path))
        (top,) = os.listdir(exp)
        tops[pkg] = (exp, exp / top)
    assert tops["jax"][1].name == tops["port"][1].name == "jmlr_k7_q5_r8_p2_e0.01"

    def setup(pkg):
        exp, top = tops[pkg]
        with open(top / "config" / "exp_setup.json") as f:
            return json.loads(f.read().replace(str(exp), "EXP"))

    assert setup("port") == setup("jax")
    for name in ("cv_assign.txt", "hyp_bound.txt"):
        got = [p for p in tops["port"][1].rglob(name)]
        want = [p for p in tops["jax"][1].rglob(name)]
        assert len(got) == len(want) == 1, name
        assert got[0].read_bytes() == want[0].read_bytes(), name
