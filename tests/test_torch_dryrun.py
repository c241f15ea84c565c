"""The port's dry-run (`launch.dryrun`) against the reference's.

- `pair_list` equal to the reference's (40 pairs, 2 skips, the overrides)
  and the reference's own spec of it (`tests/test_launch.py`);
- one `python -m repro_torch.launch.dryrun` subprocess for a decode pair:
  it writes a record with every key of the reference's record, and never
  imports `jax` or `repro`;
- argument bytes per device on the 16×16 production mesh against the
  reference's `memory_analysis().argument_size_in_bytes`, from a
  `python -m repro.launch.dryrun --no-extrapolate` subprocess: equal but
  for the integer inputs' widths (int64 here, int32 there) and the
  arguments the reference's `jax.jit` drops because the program never
  reads them;
- `run_one` on the multi-pod mesh, and `run_all`'s skip of recorded pairs
  and its exit status.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import analysis, dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.rules import _keyed, _path_str
from repro_torch.utils.trees import leaves

from test_torch_fred import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# Each pair whose argument bytes are held against the reference's, with
# the arguments the reference's jit drops (keep_unused=False): mamba2's
# decode reads no position.
ARG_PAIRS = {("tinyllama-1.1b", "decode_32k"): (),
             ("mamba2-1.3b", "decode_32k"): ("3",)}
NO_JAX = """
import runpy, sys
sys.argv = ["dryrun"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
assert not bad, bad
print("no jax, no repro")
"""


def j_pair_list():
    """The reference's `pair_list`.  Its module sets ``XLA_FLAGS`` to 512
    host devices when imported, for its own process; left set, every JAX
    backend this process starts later would hold 512 devices (the
    reference's CLI then replicates over all of them), so the variable is
    put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import pair_list
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return pair_list()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _last_record(path):
    with open(path) as f:
        return json.loads(f.readlines()[-1])


def test_pair_list_equals_the_reference():
    flags = os.environ.get("XLA_FLAGS")
    assert dryrun.pair_list() == j_pair_list()
    assert os.environ.get("XLA_FLAGS") == flags


def test_pair_list_covers_assignment():
    """The reference's spec (tests/test_launch.py) in the port."""
    pairs = dryrun.pair_list()
    assert len(pairs) == 40
    skips = [p for p in pairs if p[3]]
    assert len(skips) == 2                        # hubert decode_32k+long_500k
    assert all(p[0] == "hubert-xlarge" for p in skips)
    ov = {(p[0], p[1]): p[2] for p in pairs if p[2] is not None}
    assert ov[("llama3-8b", "long_500k")]["attn_window"] == 8192
    assert "attn_window" not in ov.get(("mamba2-1.3b", "long_500k"), {})
    assert ov[("yi-34b", "train_4k")]["remat"] is True


@pytest.fixture(scope="module")
def reference_records(tmp_path_factory):
    """The reference's records of ARG_PAIRS, one subprocess each (its
    dry-run forces 512 host devices before jax starts)."""
    out = tmp_path_factory.mktemp("ref")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
         "--shape", shape, "--no-extrapolate", "--out",
         str(out / f"{arch}.jsonl")],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for arch, shape in ARG_PAIRS]
    recs = {}
    for (arch, shape), p in zip(ARG_PAIRS, procs):
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
        recs[arch, shape] = _last_record(out / f"{arch}.jsonl")
    return recs


def test_dryrun_cli_writes_the_reference_keys_without_jax(tmp_path,
                                                          reference_records):
    out = tmp_path / "dryrun.jsonl"
    r = subprocess.run(
        [sys.executable, "-c", NO_JAX, "--arch", "tinyllama-1.1b", "--shape",
         "decode_32k", "--out", str(out)],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "no jax, no repro" in r.stdout
    lines = r.stdout.splitlines()
    assert lines[0].startswith("[dryrun] tinyllama-1.1b × decode_32k × "
                               "16x16: OK")
    assert lines[1].startswith("  memory (reckoned): arg=")
    assert lines[2].startswith("  cost (counted):  flops=")
    assert lines[3].startswith("  roofline:        compute=")
    rec = _last_record(out)
    ref = reference_records["tinyllama-1.1b", "decode_32k"]
    assert set(ref) <= set(rec)
    assert set(ref["mem"]) == set(rec["mem"])
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        ("tinyllama-1.1b", "decode_32k", "16x16", 256)
    assert rec["extrapolated"] is False and rec["status"] == "ok"
    assert rec["tag"] == "baseline" and rec["overrides"] == {}
    assert rec["mem"]["alias_bytes"] == 0
    assert (rec["coll_bytes"], rec["coll_breakdown"], rec["collective_s"]) \
        == (0.0, {}, 0.0)
    assert rec["card"] == "NVIDIA H100 80GB HBM3"
    assert rec["per_device_mem"] == rec["mem"]["arg_bytes"] + \
        rec["mem"]["temp_bytes"]
    assert rec["model_flops"] == ref["model_flops"]
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0


@pytest.mark.parametrize("pair", list(ARG_PAIRS), ids="-".join)
def test_argument_bytes_equal_the_reference(pair, reference_records):
    arch, shape = pair
    m = make_production_mesh()
    _, args, shard = steps.shardings_for(get_config(arch), shape, m)
    got = analysis.bytes_per_device(args, shard)
    widened = unused = 0
    for (path, t), s in zip(_keyed(args), leaves(shard)):
        per_dev = analysis.bytes_per_device([t], [s])
        if _path_str(path) in ARG_PAIRS[pair]:
            unused += per_dev
        elif t.dtype == torch.int64:         # the reference's are int32
            widened += per_dev // 2
    assert widened > 0
    want = reference_records[pair]["mem"]["arg_bytes"]
    assert got - widened - unused == want, (got, widened, unused, want)


def test_run_one_multi_pod(tmp_path):
    out = tmp_path / "mp.jsonl"
    rec = dryrun.run_one("tinyllama-1.1b", "decode_32k", True, out)
    assert rec == _last_record(out)
    assert (rec["mesh"], rec["chips"]) == ("2x16x16", 512)
    single = dryrun.run_one("tinyllama-1.1b", "decode_32k", False, out)
    # the same counts, split over twice the chips; the batch over pod × data
    assert rec["flops"] == pytest.approx(single["flops"] / 2, rel=1e-12)
    assert rec["hbm_bytes"] == pytest.approx(single["hbm_bytes"] / 2,
                                             rel=1e-12)
    assert rec["mem"]["arg_bytes"] < single["mem"]["arg_bytes"]


def test_run_all_skips_recorded_pairs_and_fails_loudly(tmp_path,
                                                       monkeypatch, capsys):
    out = tmp_path / "all.jsonl"
    with open(out, "w") as f:
        f.write(json.dumps({"arch": "yi-9b", "shape": "train_4k",
                            "mesh": "16x16", "status": "ok",
                            "tag": "baseline"}) + "\n")
        f.write("not json\n")
    ran = []

    def fake_run_one(arch, shape, multi_pod, out_path, overrides=None):
        ran.append((arch, shape, multi_pod, overrides))
        if (arch, shape) == ("zamba2-7b", "long_500k"):
            raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "run_one", fake_run_one)
    with pytest.raises(SystemExit) as e:
        dryrun.run_all(False, out)
    assert e.value.code == 1
    text = capsys.readouterr().out
    assert "yi-9b × train_4k: cached" in text
    assert text.count(": SKIP (encoder-only: no decode)") == 2
    assert "('zamba2-7b', 'long_500k', 'RuntimeError: boom')" in text
    assert len(ran) == 37 and not any(multi for *_, multi, _ in ran)
    assert ("llama3-8b", "long_500k", False, {"attn_window": 8192}) in ran
    # the multi-pod table does not count the single-pod record
    ran.clear()
    monkeypatch.setattr(dryrun, "run_one",
                        lambda *a, **kw: ran.append(a))
    dryrun.run_all(True, out)
    assert len(ran) == 38
    assert "all dry-runs passed" in capsys.readouterr().out


def test_cli_refuses_without_a_pair(capsys):
    with pytest.raises(SystemExit):
        dryrun.main([])
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k"])
    assert "SKIP: encoder-only: no decode" in capsys.readouterr().out
