"""The port's dry run over a (2, 4) fake process group, in a subprocess
(the group is process-wide): the counterpart of the reference's
``test_dryrun_machinery_small_mesh``, which tier-1 leaves out as
slow."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_small_mesh_in_a_fake_group(tmp_path):
    """A (2, 4) fake process group in a subprocess (the reference's
    ``test_dryrun_machinery_small_mesh``, which tier-1 leaves out as
    slow): the dense ``-smoke`` train, prefill and decode cells give
    positive flops and collective bytes; an ssm cell is recorded with
    the error that names ROADMAP A9b step 4, and the run exits 1."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = ("from repro_torch.launch import dryrun\n"
            "for arch, shape in [('starcoder2-3b-smoke', 'train_s64_b2'), "
            "('starcoder2-3b-smoke', 'prefill_s64_b2'), "
            "('starcoder2-3b-smoke', 'decode_s64_b2'), "
            "('mamba2-780m-smoke', 'train_s64_b2')]:\n"
            "    dryrun.main(['--arch', arch, '--shape', shape, '--mesh', "
            f"'small', '--out-dir', {str(tmp_path)!r}])\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "FAILURES" in proc.stdout and "A9b step 4" in proc.stdout
    for shape in ("train_s64_b2", "prefill_s64_b2", "decode_s64_b2"):
        res = json.loads((tmp_path / "small" /
                          f"starcoder2-3b-smoke__{shape}.json").read_text())
        assert res["chips"] == 8
        assert res["parsed"]["flops_per_chip"] > 0, shape
        assert res["parsed"]["collective_bytes_per_chip"] > 0, shape
        assert res["parsed"]["n_collectives"] > 0, shape
    assert not (tmp_path / "small" /
                "mamba2-780m-smoke__train_s64_b2.json").exists()
