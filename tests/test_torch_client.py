"""The port's client runtime against a real limiter segment, on the CPU.

The hypervisor face (creating the worker segment) and the client's worker
face each load their own copy of libtpf_limiter.so, since one loaded copy
holds one attached segment (tests/test_client_runtime.py does the same).
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu_torch.client import VTPUClient  # noqa: E402
from tensorfusion_tpu_torch.client import runtime as client_runtime  # noqa: E402
from tensorfusion_tpu_torch.hypervisor import DeviceQuota, Limiter  # noqa: E402
from tensorfusion_tpu_torch.models import llama  # noqa: E402
from tensorfusion_tpu_torch.ops import flash_attention  # noqa: E402

torch.set_num_threads(1)


def _copy(lib, tmp_path, tag):
    d = tmp_path / tag
    d.mkdir()
    return shutil.copy2(lib, d / os.path.basename(lib))


@pytest.fixture()
def worker_shm(limiter_lib, tmp_path):
    host = Limiter(_copy(limiter_lib, tmp_path, "host"))
    base = str(tmp_path / "shm")
    host.init(base)
    host.create_worker("ns", "w", [DeviceQuota(
        device_index=0, chip_id="gpu-0", duty_limit_bp=10000,
        hbm_limit_bytes=8 << 30, capacity_mflop=10**9,
        refill_mflop_per_s=10**9)])
    return host, os.path.join(base, "ns", "w")


@pytest.fixture()
def client(worker_shm, limiter_lib, tmp_path):
    c = VTPUClient(limiter_lib=_copy(limiter_lib, tmp_path, "cli"),
                   shm_path=worker_shm[1], device="cpu")
    assert c.attached
    yield c
    c.close()


def _flops(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def test_charge_equals_flop_counter_including_flash_op(client):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 256, 64))
                                .astype(np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))

    def step(q, k, v, w):
        return flash_attention(q, k, v, causal=True) @ w

    flops = _flops(step, q, k, v, w)
    attn = 4 * 8 * 256 * 256 * 64 // 2
    assert flops == attn + 2 * 8 * 256 * 64 * 64
    metered = client.meter(step)
    out = metered(q, k, v, w)
    torch.testing.assert_close(out, step(q, k, v, w))
    assert client.charged_mflops == int(flops / 1e6) and client.launches == 1
    metered(q, k, v, w)   # same shapes: the cost is cached
    assert client.launches == 2
    assert client.charged_mflops == 2 * int(flops / 1e6)


def test_metered_generate_charges_its_estimate(client):
    cfg = llama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_dim=256, max_seq_len=128,
                            dtype=torch.float32, attn_impl="flash")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    want = llama.generate(params, prompt, 4, cfg, device="cpu")
    flops = _flops(llama.generate, params, prompt, 4, cfg, "cpu")
    gen = client.meter(llama.generate)
    got = gen(params, prompt, 4, cfg, device="cpu")
    torch.testing.assert_close(got, want)
    assert client.charged_mflops == max(int(flops / 1e6), 1)
    assert client.launches == 1


def test_dry_bucket_blocks_then_admits(worker_shm, client):
    host, _ = worker_shm
    per_launch = 50
    # one launch of burst, then 4 launches/s of refill
    host.update_quota("ns", "w", 0, 10000, 4 * per_launch, per_launch)
    time.sleep(0.05)
    client.charge_launch(per_launch)      # drains the burst
    t0 = time.perf_counter()
    client.charge_launch(per_launch)
    client.charge_launch(per_launch)
    elapsed = time.perf_counter() - t0
    assert elapsed > 0.25, f"no throttling observed ({elapsed:.3f}s)"
    assert client.blocked_time_s > 0.2
    assert client.launches == 3


def test_frozen_worker_reports_frozen_and_blocks(worker_shm, client):
    host, _ = worker_shm
    assert not client.frozen()
    host.set_frozen("ns", "w", True)
    assert client.frozen()
    done = threading.Event()

    def run():
        client.charge_launch(1)
        done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.25)
    assert not done.is_set(), "launch went through while frozen"
    host.set_frozen("ns", "w", False)
    assert done.wait(timeout=2), "launch did not resume after thaw"
    t.join(timeout=2)
    assert not client.frozen()


def test_no_segment_runs_unmetered(limiter_lib, tmp_path, monkeypatch):
    monkeypatch.delenv("TPF_SHM_PATH", raising=False)
    monkeypatch.delenv("TPF_HYPERVISOR_URL", raising=False)
    c = VTPUClient(limiter_lib=_copy(limiter_lib, tmp_path, "none"),
                   device="cpu")
    assert not c.attached
    out = c.meter(lambda x: x * 2)(torch.arange(4))
    assert out.tolist() == [0, 2, 4, 6]
    assert c.charged_mflops == 0 and c.launches == 0
    assert c.charge_hbm(100) and not c.frozen()


def test_bootstrap_via_hypervisor(worker_shm, limiter_lib, tmp_path,
                                  monkeypatch):
    """No TPF_SHM_PATH: the client asks the hypervisor's /limiter for its
    segment and registers its PID at /process; an unreachable hypervisor
    leaves it unmetered."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    _, shm_path = worker_shm
    registered = []

    class Stub(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = json.dumps({"shm_path": shm_path}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            registered.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

    monkeypatch.delenv("TPF_SHM_PATH", raising=False)
    monkeypatch.setenv("TPF_POD_NAMESPACE", "ns")
    monkeypatch.setenv("TPF_POD_NAME", "w")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        c = VTPUClient(limiter_lib=_copy(limiter_lib, tmp_path, "boot"),
                       hypervisor_url=f"http://127.0.0.1:{httpd.server_address[1]}",
                       device="cpu")
        assert c.attached and c.shm_path == shm_path
        assert registered == [{"namespace": "ns", "pod": "w", "pid": os.getpid()}]
        c.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=2)
    dead = VTPUClient(limiter_lib=_copy(limiter_lib, tmp_path, "dead"),
                      hypervisor_url="http://127.0.0.1:1", device="cpu")
    assert not dead.attached


def test_client_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VTPUClient(shm_path=None, hypervisor_url=None)


def test_int8_product_is_counted():
    """The w8a8 product (torch._int_mm on the card) is charged 2·M·K·N."""
    a = torch.ones((32, 64), dtype=torch.int8)
    b = torch.ones((64, 16), dtype=torch.int8)
    assert _flops(torch._int_mm, a, b) == 2 * 32 * 64 * 16


def test_signature_tells_shapes_apart():
    sig = client_runtime._signature
    a, b = torch.zeros(2, 3), torch.zeros(3, 2)
    assert sig(((a,), {})) != sig(((b,), {}))
    assert sig(((a, 4), {})) != sig(((a, 5), {}))
    assert sig(((a,), {})) == sig(((torch.ones(2, 3),), {}))


def test_first_estimate_in_a_fresh_process_counts_the_attention_ops():
    """A fresh process whose first flash call comes inside the estimate
    counts the custom ops' formulas on the first estimate as on the
    second: the counter sees only the formulas registered before it was
    made, so the ops must not be first imported inside the call."""
    import subprocess
    import sys

    code = (
        "import dataclasses, torch\n"
        "from tensorfusion_tpu_torch.client.runtime import estimate_flops\n"
        "from tensorfusion_tpu_torch.models import llama\n"
        "cfg = llama.LlamaConfig.tiny('flash')\n"
        "p = llama.init_params(cfg, torch.Generator().manual_seed(0), device='cpu')\n"
        "toks = torch.zeros((1, 128), dtype=torch.long)\n"
        "fn = lambda p, t: llama.forward(p, t, cfg)\n"
        "print(estimate_flops(fn, (p, toks), {}), estimate_flops(fn, (p, toks), {}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=240, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    first, second = map(int, r.stdout.split())
    # flash forward: 4·BH·T²·D halved by the causal skip, per layer
    attention = 2 * 4 * 128 * 128 * 16 * 2
    assert first == second and first > attention
