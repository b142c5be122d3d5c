"""The port's copy of the GUI (``gui/gui.py``) under a mocked PySide6, as
the JAX package's ``tests/unit_tests/test_gui_logic.py`` tests its own:
the module imports, its non-Qt logic works, the worker runs the port's
orchestrator against the fake Hydrus server, and the backend combos offer
the port's "gpu" (the JAX package's "tpu" is not a backend of the port)."""

from __future__ import annotations

import importlib
import os
import sys

import pytest

from hydrus_video_deduplicator_tpu_torch import dedup, entrypoint

from .unit_tests.test_gui_logic import _fake_pyside

GUI = "hydrus_video_deduplicator_tpu_torch.gui.gui"


class _Anything:
    """A Qt object or enum the tests do not look at: any attribute, any call."""

    def __call__(self, *args, **kwargs):
        return _Anything()

    def __getattr__(self, name):
        return _Anything()


class _WidgetMeta(type):
    def __getattr__(cls, name):  # class-level enums such as QLineEdit.Password
        return 0


class _Widget(metaclass=_WidgetMeta):
    def __init__(self, *args, **kwargs):
        pass

    def __getattr__(self, name):
        return _Anything()


class _ComboBox(_Widget):
    """Remembers its items, so the test can read the choices offered."""

    def __init__(self, *args, **kwargs):
        self.items: list[str] = []

    def addItems(self, items):
        self.items += list(items)


def _fake_pyside_with_widgets() -> dict:
    modules = _fake_pyside()
    widgets = modules["PySide6.QtWidgets"]
    for name in (
        "QApplication QCheckBox QDoubleSpinBox QFormLayout QGroupBox QHBoxLayout QLabel"
        " QLineEdit QMainWindow QMessageBox QPlainTextEdit QPushButton QSpinBox QVBoxLayout"
        " QWidget"
    ).split():
        setattr(widgets, name, type(name, (_Widget,), {}))
    widgets.QComboBox = _ComboBox
    return modules


@pytest.fixture()
def gui_module(monkeypatch):
    for name, mod in _fake_pyside_with_widgets().items():
        monkeypatch.setitem(sys.modules, name, mod)
    sys.modules.pop(GUI, None)
    yield importlib.import_module(GUI)
    sys.modules.pop(GUI, None)


def test_gui_imports_under_mock(gui_module):
    assert hasattr(gui_module, "Worker")
    assert hasattr(gui_module, "MainWindow")
    assert hasattr(gui_module, "gui_main")
    assert gui_module.HydrusVideoDeduplicator is dedup.HydrusVideoDeduplicator


def test_progress_formatting(gui_module):
    fmt = gui_module.Worker()._format_progress
    assert fmt(dedup.HashingProgress(3, 10)) == "Hashing files: 3/10"
    assert fmt(dedup.BuildingSearchTreeProgress(1, 2)) == "Building search tree: 1/2"
    assert fmt(dedup.SearchingForDuplicatesProgress(9, 9)) == "Searching for duplicates: 9/9"
    assert fmt(dedup.DoneProgress()) == "Done."
    assert fmt(dedup.NoneProgress()) == ""


def test_skip_semaphore_logic(gui_module):
    worker = gui_module.Worker()
    assert worker._should_skip() is False
    worker.skip_step()
    assert worker._should_skip() is True
    assert worker._should_skip() is False  # consumed


def test_parameter_dataclasses(gui_module):
    params = gui_module.DedupeParameters(threshold=80.0, skip_hashing=True)
    assert params.threshold == 80.0
    assert params.custom_query == []
    assert (params.rerank, params.rerank_weights, params.rerank_threshold) == ("none", "", 0.85)
    conn = gui_module.HydrusRequestParameters(api_url="http://x", api_key="k")
    assert conn.file_service_keys == []


def test_backend_combos_offer_the_port_s_choices(gui_module):
    """The main window builds under the mock; every choice of its backend
    combos is one the port's orchestrator takes."""
    window = gui_module.MainWindow()
    assert window.search_backend_combo.items == ["auto", "tree", "gpu"]
    assert window.hash_backend_combo.items == ["auto", "native", "gpu"]
    assert window.rerank_combo.items == ["none", "clip"]
    for search in window.search_backend_combo.items:
        for hash_ in window.hash_backend_combo.items:
            dedup.HydrusVideoDeduplicator(None, None, search_backend=search, hash_backend=hash_)
    with pytest.raises(ValueError):
        dedup.HydrusVideoDeduplicator(None, None, search_backend="tpu")


def test_worker_full_flow_against_fake_hydrus(gui_module, tmp_path):
    """connect -> open db -> dedupe -> maintenance ops through the worker,
    against the fake Hydrus server, with the orchestrator's defaults."""
    from .fake_hydrus import CORPUS_EXPECTED_PAIRS, DEFAULT_ACCESS_KEY, FakeHydrus, corpus_file_store

    server = FakeHydrus(corpus_file_store())
    server.start()
    try:
        worker = gui_module.Worker()
        events = {"connect": [], "db": [], "dedupe": [], "maint": [], "progress": []}
        worker.connect_complete.connect(lambda ok, msg: events["connect"].append((ok, msg)))
        worker.init_db_complete.connect(lambda ok, msg: events["db"].append((ok, msg)))
        worker.dedupe_complete.connect(
            lambda ok, msg, pairs: events["dedupe"].append((ok, msg, pairs))
        )
        worker.maintenance_complete.connect(lambda ok, msg: events["maint"].append((ok, msg)))
        worker.dedupe_progress.connect(events["progress"].append)

        # bad key first -> failure surfaced via signal, not an exception
        worker.connect_to_hydrus(
            gui_module.HydrusRequestParameters(api_url=server.url, api_key="0" * 64)
        )
        assert events["connect"][-1][0] is False
        worker.connect_to_hydrus(
            gui_module.HydrusRequestParameters(api_url=server.url, api_key=DEFAULT_ACCESS_KEY)
        )
        assert events["connect"][-1][0] is True

        worker.init_db_connection(tmp_path / "guidb")
        assert events["db"][-1][0] is True

        worker.run_dedupe(gui_module.DedupeParameters(threshold=50.0))
        ok, msg, pairs = events["dedupe"][-1]
        assert ok and pairs == CORPUS_EXPECTED_PAIRS, msg
        assert any("Hashing files" in p for p in events["progress"])
        assert any("Done" in p for p in events["progress"])

        for op in ("vacuum", "clear_search_cache", "reset_potentials", "clear_search_tree"):
            worker.run_maintenance_op(op)
            assert events["maint"][-1][0] is True, op
        worker.run_maintenance_op("bogus")
        assert events["maint"][-1][0] is False
    finally:
        server.stop()
        os.environ.pop("HVD_DECODE_BACKEND", None)


def test_dedupe_params_reach_orchestrator(gui_module, monkeypatch):
    """Backend, sampling and rerank options flow from DedupeParameters
    through Worker.run_dedupe into the orchestrator's constructor."""
    captured = {}

    class FakeDeduper:
        def __init__(self, db, **kwargs):
            captured.update(kwargs)
            captured["db"] = db

        def deduplicate(self, skip_hashing=False):
            captured["skip_hashing"] = skip_hashing
            return 7

        threshold = 75.0

    monkeypatch.setattr(gui_module, "HydrusVideoDeduplicator", FakeDeduper)
    # the worker sets the variable itself: setenv first, so that teardown
    # restores its state from before the test and no later test in this
    # process decodes with the legacy backend
    monkeypatch.setenv("HVD_DECODE_BACKEND", "auto")
    monkeypatch.delenv("HVD_DECODE_BACKEND")
    worker = gui_module.Worker()
    worker.client = object()
    worker.db = object()
    done = []
    worker.dedupe_complete.connect(lambda ok, msg, pairs: done.append((ok, pairs)))
    params = gui_module.DedupeParameters(
        threshold=80.0,
        skip_hashing=True,
        search_backend="gpu",
        hash_backend="gpu",
        sampling="scene",
        decode_backend="legacy",
        rerank="clip",
        rerank_weights="vit.npz",
        rerank_threshold=0.9,
    )
    worker.run_dedupe(params)
    assert done == [(True, 7)]
    assert captured["search_backend"] == "gpu" and captured["hash_backend"] == "gpu"
    assert captured["sampling"] == "scene"
    assert captured["rerank"] == "clip" and captured["rerank_weights"] == "vit.npz"
    assert captured["rerank_threshold"] == 0.9
    assert os.environ.get("HVD_DECODE_BACKEND") == "legacy"
    assert captured["skip_hashing"] is True
    assert FakeDeduper.threshold == 80.0


def test_run_main_gui_without_pyside6_exits_with_the_install_hint(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "PySide6", None)  # import fails
    monkeypatch.setitem(sys.modules, "PySide6.QtCore", None)
    sys.modules.pop(GUI, None)
    with pytest.raises(SystemExit) as exc:
        entrypoint.run_main(gui=True)
    sys.modules.pop(GUI, None)
    assert exc.value.code == 1
    assert "Failed to import GUI dependencies" in " ".join(capsys.readouterr().out.split())
