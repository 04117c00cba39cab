"""``python -m repro_torch.launch.dryrun`` (the port's twins of
``tests/test_dryrun.py``, one subprocess a run, the runs started
together): a train, an MLA decode and an attention-free long-context
cell on both production meshes, the ``long_500k`` SKIP for full
attention, and the SNP exploration cell (red in the reference, whose
cell imports a name its distributed module no longer has).  Beyond the
reference's tests: every record's ``replication`` is at least 1,
SmolLM's per-card FLOPs on (2, 16, 16) are half those on (16, 16) (the
batch splits twice as far), and ``--attn-impl cuda`` counts B8 through
its FLOP formula on meta tensors: half the plain attention's products
(causal), in bf16.  (``make_production_mesh``'s shapes are
``tests/test_torch_mesh_launchers.py``'s.)"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = {
    "smollm-360m-train_4k": ["--arch", "smollm-360m", "--shape",
                             "train_4k", "--mesh", "both"],
    "minicpm3-4b-decode_32k": ["--arch", "minicpm3-4b", "--shape",
                               "decode_32k", "--mesh", "both"],
    "rwkv6-7b-long_500k": ["--arch", "rwkv6-7b", "--shape", "long_500k",
                           "--mesh", "both"],
    # the SKIP, then the SNP cell
    "skip-snp": ["--arch", "smollm-360m", "--shape", "long_500k", "--mesh",
                 "single", "--snp"],
    "prefill-ref": ["--arch", "smollm-360m", "--shape", "prefill_32k",
                    "--mesh", "single", "--attn-impl", "ref"],
    "prefill-cuda": ["--arch", "smollm-360m", "--shape", "prefill_32k",
                     "--mesh", "single", "--attn-impl", "cuda"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's (return code, stdout, stderr, out dir), run in
    parallel."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for name, args in RUNS.items():
        out = tmp_path_factory.mktemp(name)
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(out)], env=env, cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE), out)
    res = {}
    for name, (p, out) in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        res[name] = (p.returncode, stdout, stderr, out)
    return res


def _record(runs, name, fname):
    rc, stdout, stderr, out = runs[name]
    assert rc == 0, (stdout[-2000:], stderr[-2000:])
    with open(out / fname) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", "train_4k"),        # train step
    ("minicpm3-4b", "decode_32k"),      # MLA decode w/ latent cache
    ("rwkv6-7b", "long_500k"),          # attention-free long-context decode
])
def test_single_cell_both_meshes(runs, arch, shape):
    for mesh in ("16x16", "2x16x16"):
        rec = _record(runs, f"{arch}-{shape}", f"{arch}__{shape}__{mesh}.json")
        assert rec["compute_s"] > 0
        assert rec["bound"] in ("compute", "memory", "collective")
        assert rec["replication"] >= 1
        assert rec["memory"]["argument_bytes"] > 0
    # multi-pod proves the pod axis shards: 512 chips
    rec = _record(runs, f"{arch}-{shape}", f"{arch}__{shape}__2x16x16.json")
    assert rec["chips"] == 512


def test_long500k_skipped_for_full_attention(runs):
    rc, stdout, stderr, _ = runs["skip-snp"]
    assert rc == 0, stderr[-2000:]
    assert "SKIP" in stdout


def test_snp_exploration_cell(runs):
    _, _, _, out = runs["skip-snp"]
    snp = [f for f in os.listdir(out) if f.startswith("snp-")]
    assert snp, os.listdir(out)
    rec = _record(runs, "skip-snp", snp[0])
    # the exchange must actually use all_to_all on the wire
    assert rec["collective_counts"]["all-to-all"] >= 1
    assert rec["compute_s"] > 0 and rec["replication"] >= 1
    assert rec["chips"] == 256


def test_every_record_replicates_at_least_once(runs):
    seen = 0
    for name, (rc, _, _, out) in runs.items():
        assert rc == 0, name
        for f in os.listdir(out):
            if f.endswith(".json") and f != "summary.json":
                rec = _record(runs, name, f)
                assert rec["replication"] >= 1 - 1e-9, (name, f)
                seen += 1
    assert seen == 9


def test_smollm_train_flops_halve_on_the_multipod_mesh(runs):
    one, two = (_record(runs, "smollm-360m-train_4k",
                        f"smollm-360m__train_4k__{m}.json")
                for m in ("16x16", "2x16x16"))
    ratio = two["flops_per_chip"] / one["flops_per_chip"]
    assert 0.45 <= ratio <= 0.55, ratio


def test_b8_counts_half_the_plain_attention_in_bf16(runs):
    fname = "smollm-360m__prefill_32k__16x16.json"
    ref = _record(runs, "prefill-ref", fname)
    cuda = _record(runs, "prefill-cuda", fname)
    assert cuda["attn_impl"] == "cuda"
    assert set(cuda["flops_by_dtype"]) == {"bfloat16"}
    # a card's 2 sequences of 32,768, 15 heads (whole on every rank), D 64,
    # 32 layers: the plain attention's two products in full, B8's causal
    # half
    attn = 4 * 2 * 15 * 32768 ** 2 * 64 * 32
    assert ref["flops_per_chip"] - cuda["flops_per_chip"] == attn / 2
