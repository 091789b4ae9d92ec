"""The port's web GUI (``vse_tpu_torch/gui/``) with ``device="cpu"``,
mirroring ``tests/test_gui.py`` through real HTTP requests against a live
server: the event bus, the state snapshot, config persistence and
validation, the task lifecycle, videoinfo / frame / browse, the index page,
the locale, the offline version check, and an extraction through the API
whose SRT equals the JAX GUI's on the same video (each GUI with its
package's scripted engine). Also: the sync tab's fault (ROADMAP fault 12,
reference-side) shows on both GUIs, and ``cli gui`` serves with ``--device
cpu`` and raises without CUDA otherwise.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_torch_service import FakeEngine as PortFakeEngine
from tests.test_extractor_e2e import FakeEngine as JaxFakeEngine
from tests.test_extractor_e2e import write_video
from _torch_helpers import jax_full_batches
from vse_tpu.gui.server import GuiServer as JaxGuiServer
from vse_tpu_torch.gui import version as vs
from vse_tpu_torch.gui.events import EventBus
from vse_tpu_torch.gui.server import GuiServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hello world", None, "second line"]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        ctype = r.headers.get("Content-Type", "")
        data = r.read()
    return json.loads(data) if "json" in ctype else data


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read()), r.status
    except urllib.error.HTTPError as e:
        return json.loads(e.read()), e.code


@pytest.fixture()
def server(tmp_path):
    srv = GuiServer(port=0, config_path=str(tmp_path / "config.json"), device="cpu")
    srv.start()
    yield srv
    srv.shutdown()


@pytest.fixture()
def jax_server(tmp_path):
    srv = JaxGuiServer(port=0, config_path=str(tmp_path / "jax_config.json"))
    srv.start()
    yield srv
    srv.shutdown()


@pytest.fixture()
def video(tmp_path):
    path = str(tmp_path / "vid.mp4")
    write_video(path, TEXTS)
    return path


def test_event_bus_longpoll_and_resume():
    bus = EventBus(window=4)
    assert bus.wait(0, timeout=0.05) == []
    threading.Timer(0.05, lambda: bus.emit("log", message="x")).start()
    assert [e["kind"] for e in bus.wait(0, timeout=2.0)] == ["log"]
    for i in range(6):
        bus.emit("log", message=str(i))
    assert [e["message"] for e in bus.since(0)] == ["2", "3", "4", "5"]
    assert bus.since(bus.seq) == []


def test_state_snapshot(server, jax_server):
    st = _get(server.address[1], "/api/state")
    jst = _get(jax_server.address[1], "/api/state")
    assert st["running"] is False and st["sync_running"] is False
    assert sorted(st) == sorted(jst)
    assert st["languages"] == jst["languages"] and st["modes"] == jst["modes"]
    assert st["locales"] == jst["locales"] and st["version"] == jst["version"]
    assert "language" in st["config"] and "mode" in st["config"]
    assert server.service.device == torch.device("cpu")


def test_config_update_persist_and_validation(server, tmp_path):
    port = server.address[1]
    r, code = _post(port, "/api/config", {"updates": {"extract_frequency": 5, "mode": "accurate"}})
    assert code == 200 and r["ok"]
    with open(tmp_path / "config.json") as f:
        saved = json.load(f)
    assert saved["Main"]["ExtractFrequency"] == 5 and saved["Main"]["Mode"] == "accurate"
    assert _get(port, "/api/state")["config"]["extract_frequency"] == 5
    assert _post(port, "/api/config", {"updates": {"bogus": 1}})[1] == 400
    assert _post(port, "/api/config", {"updates": {"extract_frequency": 999}})[1] == 400
    server.service._engine = object()
    _post(port, "/api/config", {"updates": {"language": "ru"}})
    assert server.service._engine is None
    # a restarted GUI reads the persisted config
    again = GuiServer(port=0, config_path=str(tmp_path / "config.json"), device="cpu")
    try:
        assert again.service.config.language == "ru" and again.service.config.extract_frequency == 5
    finally:
        again.httpd.server_close()


def test_task_lifecycle_and_events(server, video):
    port = server.address[1]
    row, code = _post(port, "/api/tasks", {"video_path": video, "area": "0.8,1.0,0.0,1.0",
                                           "ab": [0, 100]})
    assert code == 201 and row["status"] == "pending" and row["area"] == [192, 240, 0, 320]
    assert _post(port, "/api/tasks", {"video_path": "/nope.mp4"})[1] == 400
    assert len(_get(port, "/api/state")["tasks"]) == 1
    evts = _get(port, "/api/events?since=0&timeout=0.2")["events"]
    assert any(e["kind"] == "task_added" for e in evts)
    r, _ = _post(port, "/api/tasks/remove", {"id": row["id"]})
    assert r["removed"] is True and _get(port, "/api/state")["tasks"] == []
    assert _post(port, "/api/nope", {})[1] == 404


def test_videoinfo_frame_and_browse(server, jax_server, video):
    port = server.address[1]
    info = _get(port, f"/api/videoinfo?path={video}")
    assert info == _get(jax_server.address[1], f"/api/videoinfo?path={video}")
    assert (info["width"], info["height"]) == (320, 240)
    jpg = _get(port, f"/api/frame?path={video}&t=0.5&w=160")
    assert jpg[:2] == b"\xff\xd8"
    listing = _get(port, f"/api/browse?dir={os.path.dirname(video)}")
    assert any(e["name"] == "vid.mp4" for e in listing["entries"])


def test_index_served(server):
    html = _get(server.address[1], "/")
    assert b"vse-tpu" in html and b"Timeline" in html
    with open(os.path.join(ROOT, "vse_tpu", "gui", "static", "index.html"), "rb") as f:
        assert html == f.read()  # the port's copy of the page


def test_locale_roundtrip(server):
    port = server.address[1]
    assert _post(port, "/api/locale", {"locale": "ch"})[1] == 200
    assert _get(port, "/api/state")["locale"] == "ch"
    _post(port, "/api/locale", {"locale": "en"})


def test_version_offline(monkeypatch):
    monkeypatch.setattr(vs, "UPDATE_URLS", ["http://127.0.0.1:1/x"])
    r = vs.check_updates(timeout=0.3)
    assert r["status"] == "offline" and r["current"] == vs.VERSION
    assert vs._version_tuple("v1.2.10") > vs._version_tuple("1.2.9")


def drain(port, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = _get(port, "/api/state")
        if st["tasks"][0]["status"] in ("completed", "failed") and not st["running"]:
            return st["tasks"][0]
        time.sleep(0.2)
    raise AssertionError("the queue did not finish")


def test_run_extraction_through_api_equals_the_jax_gui(server, jax_server, video, tmp_path):
    """The home tab's flow (add -> run -> progress -> finish) on both GUIs,
    each with its package's scripted engine: the SRTs byte-equal."""
    server.service._engine = PortFakeEngine(TEXTS)
    jax_server.service._engine = JaxFakeEngine(TEXTS)
    srts = []
    with jax_full_batches():
        for srv in (server, jax_server):
            port = srv.address[1]
            out = str(tmp_path / f"out{port}.srt")
            _post(port, "/api/tasks", {"video_path": video, "area": "0.8,1.0,0.0,1.0",
                                       "output_path": out})
            assert _post(port, "/api/run", {})[0]["started"] is True
            task = drain(port)
            assert task["status"] == "completed", task
            with open(out, "rb") as f:
                srts.append(f.read())
            kinds = {e["kind"] for e in _get(port, "/api/events?since=0&timeout=0.2")["events"]}
            assert {"finish", "progress", "run_started"} <= kinds
            assert _post(port, "/api/run", {})[0]["started"] is False
    assert srts[0] == srts[1] and srts[0].count(b"-->") == 2


def wait_sync_done(port, timeout=120):
    deadline, seq = time.time() + timeout, 0
    while time.time() < deadline:
        for e in _get(port, f"/api/events?since={seq}&timeout=2")["events"]:
            seq = e["seq"]
            if e["kind"] == "sync_done":
                return e
    raise AssertionError("no sync_done event")


def test_sync_tab_fault_12_on_both_guis(server, jax_server, tmp_path, monkeypatch):
    """ROADMAP fault 12 (reference-side): the sync tab passes SRC and DST as
    positional arguments, which the re-timer's parser refuses (it needs
    --src and --dst), so both GUIs' runs end with returncode 2."""
    monkeypatch.chdir(ROOT)
    body = {"src": str(tmp_path / "a.wav"), "dst": str(tmp_path / "b.wav"),
            "script": str(tmp_path / "a.srt")}
    for srv, module in ((server, "vse_tpu_torch.sync.cli"), (jax_server, "vse_tpu.sync.cli")):
        port = srv.address[1]
        r, code = _post(port, "/api/sync", body)
        assert code == 200 and r["started"] is True
        started = [e for e in _get(port, "/api/events?since=0&timeout=1")["events"]
                   if e["kind"] == "sync_started"]
        assert started[0]["argv"][1:] == ["-u", "-m", module, body["src"], body["dst"],
                                          "--script", body["script"]]
        done = wait_sync_done(port)
        assert done["returncode"] == 2
        logs = [e["message"] for e in _get(port, "/api/events?since=0&timeout=0.2")["events"]
                if e["kind"] == "sync_log"]
        assert any("the following arguments are required: --src, --dst" in m for m in logs)


def test_gui_needs_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GuiServer(port=0, config_path=str(tmp_path / "c.json"))
    r = subprocess.run([sys.executable, "-m", "vse_tpu_torch.cli", "gui", "--port", "0",
                        "--config", str(tmp_path / "c.json")], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_cli_gui_serves_on_the_cpu(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "vse_tpu_torch.cli", "gui", "--port", "0", "--device", "cpu",
         "--config", str(tmp_path / "c.json")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("vse gui listening on http://127.0.0.1:"), line
        port = int(line.rsplit(":", 1)[1])
        st = _get(port, "/api/state")
        assert st["running"] is False and "en" in st["languages"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
