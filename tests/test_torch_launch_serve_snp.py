"""The port's ``launch.serve --snp`` on the CPU: the async trace service,
over the one-device trace mesh ``[cpu]`` (the mesh runner), serves a
burst of random traces of the paper's Π and prints its set-up (the
reference's ``[serve-snp] mesh N-device, …`` line),
served-count and latency lines; an injected poison seed fails exactly one
request; the sample spike train is the reference's ``run_trace`` of that
seed."""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro_torch.launch.serve import main, parse_inject  # noqa: E402
from repro_torch.runtime import FaultInjector  # noqa: E402

PI = J.paper_pi(True)


def _run(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = main(["--snp", "--device", "cpu", *argv])
    return got, out.getvalue().splitlines()


def _sample(lines):
    line = next(x for x in lines if "sample spike train" in x)
    return eval(line.split(": ", 1)[1])     # a printed list of ints


def test_snp_launcher_prints_its_lines():
    got, lines = _run("--requests", "64", "--batch", "16", "--gen", "8")
    assert lines[0].startswith("[serve-snp] mesh 1-device, batch 16, "
                               "max_delay 5.0 ms, backend cuda")
    assert got["mesh"] == ["cpu"]
    assert lines[1].startswith("[serve-snp] 64/64 traces x 8 steps in ")
    assert "traces/s" in lines[1] and "device calls" in lines[1]
    assert lines[2].startswith("[serve-snp] completion latency p50=")
    assert not any("fault stats" in x or "failed" in x for x in lines)
    assert got["served"] == got["requests"] == 64 and got["failed"] == []
    assert got["stats"]["traces_served"] == 64
    assert got["p50_ms"] <= got["p99_ms"]
    want = J.run_trace(PI, steps=8, policy="random", seed=0)
    assert _sample(lines) == np.asarray(want.emissions).tolist()


def test_snp_launcher_injected_poison_fails_exactly_one():
    got, lines = _run("--requests", "64", "--batch", "16", "--gen", "8",
                      "--inject", "poison=3", "--backoff-ms", "0")
    assert got["served"] == 63 and got["failed"] == ["PoisonError"]
    failed = [x for x in lines if "request failed" in x]
    assert len(failed) == 1 and "PoisonError" in failed[0] \
        and "seed [3]" in failed[0]
    assert any(x.startswith("[serve-snp] 63/64 traces") for x in lines)
    stats = next(x for x in lines if "fault stats" in x)
    assert "failed_requests=1" in stats and "bisections=" in stats
    assert got["stats"]["failed_requests"] == 1


def test_snp_launcher_smoke_schedule():
    """The smoke's launcher run, at its size, on the CPU: 256 requests in
    batches of 64, ``fail=2 poison=17`` with one retry."""
    got, lines = _run("--requests", "256", "--batch", "64", "--gen", "32",
                      "--inject", "fail=2 poison=17", "--max-retries", "1",
                      "--backoff-ms", "0")
    assert got["served"] == 255 and got["failed"] == ["PoisonError"]
    assert "policy FaultPolicy(max_retries=1" in lines[0]
    clean, _ = _run("--requests", "256", "--batch", "64", "--gen", "32")
    assert clean["served"] == 256 and clean["stats"]["failed_calls"] == 0


def test_snp_batch_defaults_to_the_service_batch():
    _, lines = _run("--requests", "4", "--gen", "4", "--backend", "ref")
    assert "batch 256" in lines[0] and "backend ref" in lines[0]


def test_parse_inject():
    inj = parse_inject("fail=2,4 poison=17,5 slow=3:0.05")
    assert isinstance(inj, FaultInjector)
    assert inj.fail_calls == {2, 4} and inj.poison_seeds == {17, 5}
    assert inj.slow_calls == {3: 0.05}
    with pytest.raises(SystemExit, match="unknown --inject term"):
        parse_inject("crash=1")


def test_snp_device_none_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --snp serves there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--snp", "--requests", "4"])
