"""HTTP JSON API wrapping ExtractionService for the web GUI (the port of
``vse_tpu/gui/server.py``).

The reference GUI's orchestration layer (reference ui/home_interface.py:
307-456: task queue worker, RPC callback wiring, config persistence;
gui.py:33-190: window + tabs) becomes a threaded stdlib HTTP server.
State lives in ``GuiServer``; the browser is stateless and drives it
through the endpoints below. No third-party web framework (the image has
none) — ``http.server`` is enough for a local single-user tool. The
server's ``ExtractionService`` runs on the device it is given (``cuda``
unless ``cpu``; it raises without CUDA); the sync tab launches
``vse_tpu_torch.sync.cli`` as the JAX GUI launches its own, with the same
argv (SRC and DST as positional arguments, which that parser refuses:
the tab's runs end with returncode 2 on both GUIs).

Endpoints (JSON unless noted):
  GET  /                         single-page app (static/index.html)
  GET  /api/state                tasks + config + catalog + version snapshot
  GET  /api/events?since=N       long-poll event stream (EventBus)
  GET  /api/videoinfo?path=      width/height/fps/frames/duration
  GET  /api/frame?path=&t=&w=    JPEG preview frame (image/jpeg)
  GET  /api/browse?dir=          directory listing for the file picker
  GET  /api/version/check        release update check (mirrored, offline-safe)
  POST /api/tasks                add {video_path, area?, ab?, output_path?}
  POST /api/tasks/remove         {id}
  POST /api/run                  start draining the queue
  POST /api/stop                 cooperative stop
  POST /api/config               {updates: {field: value}} apply + persist
  POST /api/locale               {locale}
  POST /api/sync                 {src, dst, script?, args?} timeline re-timer
"""

from __future__ import annotations

import json
import os
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Union

import torch

from vse_tpu_torch.core import i18n
from vse_tpu_torch.core.config import LANGUAGES, Mode, VseConfig
from vse_tpu_torch.core.subtitle_area import ABSection, SubtitleArea
from vse_tpu_torch.gui import version as version_service
from vse_tpu_torch.gui.events import EventBus
from vse_tpu_torch.gui.runner import AsyncRunner
from vse_tpu_torch.pipeline.service import Callbacks, ExtractionService

# config fields whose change invalidates the compiled engine (model
# selection happens on these — core/registry.py resolve())
_ENGINE_KEYS = {"language", "mode", "hardware_acceleration", "rec_rectify",
                "compute_dtype", "det_image_height", "det_image_width",
                "rec_image_height", "rec_image_width"}

_VIDEO_EXTS = (".mp4", ".mkv", ".avi", ".mov", ".webm", ".ts", ".flv", ".wmv")


def _parse_area(spec: str, width: int, height: int,
                ab: Optional[list] = None) -> Optional[SubtitleArea]:
    """'ymin,ymax,xmin,xmax' — ratios if all <= 1.0, else pixels (same
    contract as the CLI / reference interactive prompt)."""
    if not spec:
        return None
    parts = [float(t) for t in spec.replace(";", ",").split(",")[:4]]
    if len(parts) != 4:
        raise ValueError(f"expected 4 area values, got {len(parts)}")
    if all(p <= 1.0 for p in parts):
        area = SubtitleArea.from_ratios(
            ",".join(str(p) for p in parts), width, height
        )
    else:
        ymin, ymax, xmin, xmax = (int(p) for p in parts)
        area = SubtitleArea(ymin, ymax, xmin, xmax)
    if ab and len(ab) == 2:
        area.ab_section = ABSection(int(ab[0]), int(ab[1]))
    return area


class GuiServer:
    """Application state + HTTP server (call .serve_forever() or .start())."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8765,
                 config_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.config_path = config_path or os.path.join("config", "config.json")
        cfg = VseConfig()
        if os.path.exists(self.config_path):
            try:
                cfg = VseConfig.from_json(self.config_path)
            except (OSError, ValueError, json.JSONDecodeError) as e:
                print(f"config load failed ({e}); using defaults")
        self.bus = EventBus()
        self.service = ExtractionService(config=cfg, callbacks=Callbacks(
            on_progress=self._on_progress,
            on_log=self._on_log,
            on_finish=self._on_finish,
            on_error=self._on_error,
        ), device=device)
        self._next_id = 1
        self._id_lock = threading.Lock()
        self._sync_runner: Optional[AsyncRunner] = None
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True

    # --- lifecycle ----------------------------------------------------------

    @property
    def address(self):
        return self.httpd.server_address

    def start(self) -> None:
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def serve_forever(self) -> None:
        host, port = self.address
        print(f"vse gui listening on http://{host}:{port}")
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # --- service callbacks -> event bus (the RPC bridge, G7) ----------------

    def _task_id(self, task) -> int:
        return getattr(task, "_gui_id", -1)

    def _on_progress(self, task, fe, ocr):
        self.bus.emit("progress", task=self._task_id(task),
                      frame_extract=round(fe, 2), ocr=round(ocr, 2),
                      total=round(task.progress, 2))

    def _on_log(self, task, msg):
        self.bus.emit("log", task=self._task_id(task), message=msg)

    def _on_finish(self, task):
        self.bus.emit("finish", task=self._task_id(task), srt=task.srt_path)

    def _on_error(self, task, err):
        self.bus.emit("error", task=self._task_id(task), message=err)

    # --- state --------------------------------------------------------------

    def _task_row(self, task) -> Dict:
        return {
            "id": self._task_id(task),
            "video_path": task.video_path,
            "status": task.status.value,
            "progress": round(task.progress, 2),
            "srt_path": task.srt_path,
            "error": (task.error or "").splitlines()[0] if task.error else None,
            "area": list(task.sub_area.as_tuple()) if task.sub_area else None,
        }

    def state(self) -> Dict:
        cfg = self.service.config
        cfg_dict = {}
        for f in type(cfg).__dataclass_fields__:
            v = getattr(cfg, f)
            cfg_dict[f] = v.value if hasattr(v, "value") else v
        return {
            "tasks": [self._task_row(t) for t in self.service.tasks],
            "running": self.service.running,
            "config": cfg_dict,
            "languages": list(LANGUAGES),
            "modes": [m.value for m in Mode],
            "locales": i18n.available_locales(),
            "locale": i18n.get_locale(),
            "version": version_service.info(),
            "event_seq": self.bus.seq,
            "sync_running": bool(self._sync_runner and self._sync_runner.running),
        }

    # --- mutations ----------------------------------------------------------

    def add_task(self, body: Dict) -> Dict:
        path = body.get("video_path", "")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"not found: {path}")
        area = None
        if body.get("area"):
            from vse_tpu_torch.video.decode import probe

            meta = probe(path)
            area = _parse_area(body["area"], meta.width, meta.height,
                               ab=body.get("ab"))
        task = self.service.add_task(path, sub_area=area,
                                     output_path=body.get("output_path"))
        with self._id_lock:
            task._gui_id = self._next_id
            self._next_id += 1
        self.bus.emit("task_added", task=task._gui_id, video_path=path)
        return self._task_row(task)

    def remove_task(self, task_id: int) -> bool:
        for t in self.service.tasks:
            if self._task_id(t) == task_id:
                ok = self.service.remove_task(t)
                if ok:
                    self.bus.emit("task_removed", task=task_id)
                return ok
        return False

    def run(self) -> Dict:
        if self.service.running:
            return {"started": False, "reason": "already running"}
        if not any(t.status.value == "pending" for t in self.service.tasks):
            return {"started": False, "reason": "no pending tasks"}
        self.service.run_all(block=False)
        self.bus.emit("run_started")
        return {"started": True}

    def stop(self) -> Dict:
        self.service.stop()
        self.bus.emit("run_stopped")
        return {"stopped": True}

    def update_config(self, updates: Dict) -> Dict:
        cfg = self.service.config
        fields = type(cfg).__dataclass_fields__
        clean = {}
        for k, v in updates.items():
            if k not in fields:
                raise KeyError(f"unknown config field: {k}")
            current = getattr(cfg, k)
            if isinstance(current, bool):
                v = bool(v)
            elif isinstance(current, int) and not isinstance(current, bool):
                v = int(v)
            elif isinstance(current, float):
                v = float(v)
            clean[k] = v
        new_cfg = cfg.replace(**clean)  # validates ranges (__post_init__)
        self.service.config = new_cfg
        if _ENGINE_KEYS & set(clean):
            self.service.invalidate_engine()
        self._persist_config(new_cfg)
        self.bus.emit("config_changed", fields=sorted(clean))
        return {"ok": True}

    def _persist_config(self, cfg: VseConfig) -> None:
        """Reference-format config/config.json (backend/config.py persists
        through QConfig to the same shape — VseConfig.from_json reads it)."""
        d = os.path.dirname(self.config_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.config_path, "w", encoding="utf-8") as f:
            json.dump(cfg.to_json(), f, indent=1)

    def set_locale(self, locale: str) -> Dict:
        i18n.set_locale(locale)
        self.bus.emit("locale_changed", locale=locale)
        return {"ok": True, "locale": locale}

    def start_sync(self, body: Dict) -> Dict:
        """Timeline-sync tab: run the re-timer as a subprocess with piped
        logs (reference ui/timeline_sync_interface.py:167-172 runs
        ``python -u sushi`` the same way)."""
        if self._sync_runner and self._sync_runner.running:
            return {"started": False, "reason": "sync already running"}
        argv = [sys.executable, "-u", "-m", "vse_tpu_torch.sync.cli",
                body["src"], body["dst"]]
        if body.get("script"):
            argv += ["--script", body["script"]]
        argv += [str(a) for a in body.get("args", [])]

        def on_line(stream, line):
            self.bus.emit("sync_log", stream=stream, message=line)

        def on_exit(rc):
            self.bus.emit("sync_done", returncode=rc)

        self._sync_runner = AsyncRunner(argv, on_line=on_line, on_exit=on_exit)
        self._sync_runner.start()
        self.bus.emit("sync_started", argv=argv)
        return {"started": True}

    # --- media helpers ------------------------------------------------------

    def video_info(self, path: str) -> Dict:
        from vse_tpu_torch.video.decode import probe

        meta = probe(path)
        return {
            "width": meta.width, "height": meta.height, "fps": meta.fps,
            "frames": meta.frame_count,
            "duration": meta.frame_count / meta.fps if meta.fps else 0.0,
        }

    def frame_jpeg(self, path: str, t: float, width: int = 0) -> bytes:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            if t > 0:
                cap.set(cv2.CAP_PROP_POS_MSEC, t * 1000.0)
            ok, frame = cap.read()
            if not ok:
                raise ValueError(f"no frame at t={t}")
            if width and frame.shape[1] > width:
                h = int(frame.shape[0] * width / frame.shape[1])
                frame = cv2.resize(frame, (width, h))
            ok, buf = cv2.imencode(".jpg", frame,
                                   [cv2.IMWRITE_JPEG_QUALITY, 85])
            if not ok:
                raise ValueError("jpeg encode failed")
            return buf.tobytes()
        finally:
            cap.release()

    def browse(self, directory: str) -> Dict:
        directory = os.path.abspath(directory or os.getcwd())
        entries = []
        try:
            for name in sorted(os.listdir(directory)):
                if name.startswith("."):
                    continue
                full = os.path.join(directory, name)
                if os.path.isdir(full):
                    entries.append({"name": name, "dir": True})
                elif name.lower().endswith(_VIDEO_EXTS):
                    entries.append({"name": name, "dir": False,
                                    "size": os.path.getsize(full)})
        except OSError as e:
            return {"dir": directory, "error": str(e), "entries": []}
        return {"dir": directory,
                "parent": os.path.dirname(directory), "entries": entries}


def _make_handler(app: GuiServer):
    static_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "static")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet request spam
            pass

        def _json(self, obj, code: int = 200):
            data = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _bytes(self, data: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            try:
                parsed = urllib.parse.urlparse(self.path)
                q = {k: v[0] for k, v in
                     urllib.parse.parse_qs(parsed.query).items()}
                route = parsed.path
                if route in ("/", "/index.html"):
                    with open(os.path.join(static_dir, "index.html"), "rb") as f:
                        self._bytes(f.read(), "text/html; charset=utf-8")
                elif route == "/api/state":
                    self._json(app.state())
                elif route == "/api/events":
                    since = int(q.get("since", 0))
                    timeout = min(float(q.get("timeout", 25)), 55.0)
                    self._json({"events": app.bus.wait(since, timeout),
                                "seq": app.bus.seq})
                elif route == "/api/videoinfo":
                    self._json(app.video_info(q["path"]))
                elif route == "/api/frame":
                    data = app.frame_jpeg(q["path"], float(q.get("t", 0)),
                                          int(q.get("w", 0)))
                    self._bytes(data, "image/jpeg")
                elif route == "/api/browse":
                    self._json(app.browse(q.get("dir", "")))
                elif route == "/api/version/check":
                    self._json(version_service.check_updates())
                else:
                    self._json({"error": "not found"}, 404)
            except (KeyError, ValueError, FileNotFoundError) as e:
                self._json({"error": str(e)}, 400)
            except BrokenPipeError:
                pass
            except Exception as e:  # surface, don't kill the thread
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                route = urllib.parse.urlparse(self.path).path
                if route == "/api/tasks":
                    self._json(app.add_task(body), 201)
                elif route == "/api/tasks/remove":
                    self._json({"removed": app.remove_task(int(body["id"]))})
                elif route == "/api/run":
                    self._json(app.run())
                elif route == "/api/stop":
                    self._json(app.stop())
                elif route == "/api/config":
                    self._json(app.update_config(body.get("updates", body)))
                elif route == "/api/locale":
                    self._json(app.set_locale(body["locale"]))
                elif route == "/api/sync":
                    self._json(app.start_sync(body))
                else:
                    self._json({"error": "not found"}, 404)
            except (KeyError, ValueError, FileNotFoundError) as e:
                self._json({"error": str(e)}, 400)
            except BrokenPipeError:
                pass
            except Exception as e:
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    return Handler


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="vse gui")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    GuiServer(args.host, args.port, config_path=args.config,
              device=args.device).serve_forever()


if __name__ == "__main__":
    main()
