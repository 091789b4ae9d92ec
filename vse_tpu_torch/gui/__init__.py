"""Browser-based GUI for the extraction pipeline (the port of
``vse_tpu/gui/``, on the port's ``ExtractionService``).

The reference ships a PySide6 desktop GUI (reference gui.py:33-190,
ui/home_interface.py, ui/component/video_display_component.py). A Qt
desktop app makes no sense on a headless accelerator host, so the same
surface is rebuilt as a zero-dependency web app: a stdlib
``http.server`` JSON API (vse_tpu/gui/server.py) wrapping the existing
``ExtractionService``, plus a single-page frontend
(vse_tpu/gui/static/index.html). Feature parity map:

- main window, 3 tabs (reference gui.py:33-190)        -> tabbed SPA
- home/task queue (ui/home_interface.py:307-456)       -> /api/tasks + run/stop
- video display + ratio selection + AB sections
  (ui/component/video_display_component.py)            -> canvas overlay
- task list (ui/component/task_list_component.py)      -> task table
- settings cards (ui/*setting_interface.py)            -> settings tab
- timeline sync tab (ui/timeline_sync_interface.py)    -> sync tab
- RPC bridge (backend/tools/subtitle_extractor_remote_call.py)
                                                       -> EventBus + long-poll
- async runner (backend/tools/python_runner.py)        -> worker threads
- theme listener (backend/tools/theme_listener.py)     -> CSS theme toggle
- version service (backend/tools/version_service.py)   -> /api/version

Run:  python -m vse_tpu_torch.cli gui --port 8765 [--device cpu]
"""

from vse_tpu_torch.gui.server import GuiServer  # noqa: F401
