"""PySide6 GUI.

Architecture mirrors the reference (upstream
src/hydrusvideodeduplicator/gui/gui.py): a ``Worker`` QObject moved onto a
QThread owns all long-running operations (connect, db open/upgrade, dedupe,
maintenance); the ``MainWindow`` communicates with it exclusively through
request/complete signal pairs (queued connections, so the Qt event loop
stays live); dedupe progress flows back through the orchestrator's
DedupeProgress dataclass protocol; "skip current step" is signaled through
a semaphore polled by the orchestrator's should_skip_step_fn.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

from PySide6.QtCore import QObject, QSemaphore, Qt, QThread, Signal, Slot
from PySide6.QtWidgets import (
    QApplication,
    QCheckBox,
    QComboBox,
    QDoubleSpinBox,
    QFormLayout,
    QGroupBox,
    QHBoxLayout,
    QLabel,
    QLineEdit,
    QMainWindow,
    QMessageBox,
    QPlainTextEdit,
    QPushButton,
    QSpinBox,
    QVBoxLayout,
    QWidget,
)

from .. import config
from ..__about__ import __version__
from ..client import ClientAPIException, FailedHVDClientConnection, HVDClient, create_client
from ..db import DedupeDB
from ..dedup import (
    BuildingSearchTreeProgress,
    DoneProgress,
    HashingProgress,
    HydrusVideoDeduplicator,
    NoneProgress,
    SearchingForDuplicatesProgress,
)

log = logging.getLogger("gui")

_DARK_STYLESHEET = """
QWidget { background-color: #202124; color: #e8eaed; font-size: 13px; }
QLineEdit, QPlainTextEdit, QSpinBox, QDoubleSpinBox {
    background-color: #2b2c2f; border: 1px solid #3c4043; border-radius: 4px;
    padding: 4px;
}
QPushButton {
    background-color: #3c4043; border: 1px solid #5f6368; border-radius: 4px;
    padding: 6px 14px;
}
QPushButton:hover { background-color: #49494d; }
QPushButton:disabled { color: #9aa0a6; }
QGroupBox { border: 1px solid #3c4043; border-radius: 6px; margin-top: 8px; }
QGroupBox::title { subcontrol-origin: margin; left: 8px; padding: 0 4px; }
"""


@dataclass
class HydrusRequestParameters:
    api_url: str = ""
    api_key: str = ""
    verify_cert: str | None = None
    file_service_keys: list[str] = field(default_factory=list)


@dataclass
class DedupeParameters:
    threshold: float = 50.0
    skip_hashing: bool = False
    job_count: int = -2
    custom_query: list[str] = field(default_factory=list)
    failed_page_name: str | None = None
    search_backend: str = "auto"
    search_prefilter: str = "auto"
    hash_backend: str = "auto"
    sampling: str = "uniform"
    decode_backend: str = "auto"
    rerank: str = "none"
    rerank_weights: str = ""
    rerank_threshold: float = 0.85


class Worker(QObject):
    """All blocking work happens here, on a dedicated QThread."""

    connect_complete = Signal(bool, str)
    init_db_complete = Signal(bool, str)
    dedupe_progress = Signal(str)
    dedupe_complete = Signal(bool, str, int)
    maintenance_complete = Signal(bool, str)

    def __init__(self):
        super().__init__()
        self.client: HVDClient | None = None
        self.db: DedupeDB.DedupeDb | None = None
        self.skip_semaphore = QSemaphore(0)

    # -- connection -------------------------------------------------------

    @Slot(object)
    def connect_to_hydrus(self, params: HydrusRequestParameters) -> None:
        try:
            self.client = create_client(
                params.file_service_keys or None,
                params.api_url,
                params.api_key,
                params.verify_cert,
            )
            self.client.verify_permissions()
            version = self.client.get_hydrus_api_version()
        except (FailedHVDClientConnection, ClientAPIException) as exc:
            self.client = None
            self.connect_complete.emit(False, f"{exc.pretty_msg}\n{exc}")
            return
        self.connect_complete.emit(True, f"Connected (Hydrus API v{version}).")

    # -- database ---------------------------------------------------------

    @Slot(object)
    def init_db_connection(self, db_dir: Path) -> None:
        try:
            DedupeDB.set_db_dir(Path(db_dir))
            if not DedupeDB.does_db_exist():
                DedupeDB.create_db()
            db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
            db.init_connection()
            db.begin_transaction()
            with db.conn:
                upgraded = db.upgrade_db()
            if upgraded:
                db.vacuum()
            self.db = db
            stats = DedupeDB.get_db_stats(db)
            msg = (
                f"Database ready: {stats.num_videos} videos hashed,"
                f" {stats.file_size} bytes."
            )
        except Exception as exc:
            self.db = None
            self.init_db_complete.emit(False, str(exc))
            return
        self.init_db_complete.emit(True, msg)

    # -- dedupe -----------------------------------------------------------

    def _format_progress(self, progress) -> str:
        if isinstance(progress, HashingProgress):
            return f"Hashing files: {progress.complete}/{progress.total}"
        if isinstance(progress, BuildingSearchTreeProgress):
            return f"Building search tree: {progress.complete}/{progress.total}"
        if isinstance(progress, SearchingForDuplicatesProgress):
            return f"Searching for duplicates: {progress.complete}/{progress.total}"
        if isinstance(progress, DoneProgress):
            return "Done."
        if isinstance(progress, NoneProgress):
            return ""
        return str(progress)

    def _should_skip(self) -> bool:
        return self.skip_semaphore.tryAcquire()

    @Slot(object)
    def run_dedupe(self, params: DedupeParameters) -> None:
        if self.client is None or self.db is None:
            self.dedupe_complete.emit(False, "Connect to Hydrus and open the DB first.", 0)
            return
        try:
            # drain stale skip requests
            while self.skip_semaphore.tryAcquire():
                pass
            import os

            from ..decode.backends import DECODE_BACKEND_ENV

            os.environ[DECODE_BACKEND_ENV] = params.decode_backend
            HydrusVideoDeduplicator.threshold = params.threshold
            deduper = HydrusVideoDeduplicator(
                self.db,
                client=self.client,
                job_count=params.job_count,
                failed_page_name=params.failed_page_name,
                custom_query=params.custom_query or None,
                update_progress_callback=lambda p: self.dedupe_progress.emit(
                    self._format_progress(p)
                ),
                should_skip_step_fn=self._should_skip,
                search_backend=params.search_backend,
                search_prefilter=params.search_prefilter,
                hash_backend=params.hash_backend,
                sampling=params.sampling,
                rerank=params.rerank,
                rerank_weights=params.rerank_weights or None,
                rerank_threshold=params.rerank_threshold,
            )
            pairs = deduper.deduplicate(skip_hashing=params.skip_hashing)
        except Exception as exc:
            log.exception("dedupe failed")
            self.dedupe_complete.emit(False, str(exc), 0)
            return
        self.dedupe_complete.emit(True, f"Found {pairs} similar pairs.", pairs)

    @Slot()
    def skip_step(self) -> None:
        self.skip_semaphore.release()

    # -- maintenance -------------------------------------------------------

    @Slot(str)
    def run_maintenance_op(self, op: str) -> None:
        if self.db is None:
            self.maintenance_complete.emit(False, "Open the DB first.")
            return
        try:
            if op == "vacuum":
                self.db.vacuum()
                msg = "Vacuumed the database."
            elif op == "clear_search_tree":
                self.db.begin_transaction()
                with self.db.conn:
                    self.db.clear_search_tree()
                msg = "Cleared the search tree."
            elif op == "clear_search_cache":
                self.db.begin_transaction()
                with self.db.conn:
                    self.db.clear_search_cache()
                msg = "Cleared the search cache."
            elif op == "reset_potentials":
                if self.client is None:
                    raise RuntimeError("Connect to Hydrus first.")
                hashes = self.db.get_phashed_files()
                self.client.reset_potential_duplicates(hashes)
                msg = "Reset all potential duplicates in Hydrus."
            else:
                raise ValueError(f"unknown op {op}")
        except Exception as exc:
            self.maintenance_complete.emit(False, str(exc))
            return
        self.maintenance_complete.emit(True, msg)


class MainWindow(QMainWindow):
    connect_requested = Signal(object)
    init_db_requested = Signal(object)
    dedupe_requested = Signal(object)
    skip_requested = Signal()
    maintenance_requested = Signal(str)

    def __init__(self):
        super().__init__()
        self.setWindowTitle(f"Hydrus Video Deduplicator (PyTorch/CUDA port) {__version__}")
        self.resize(760, 640)

        self.worker = Worker()
        self.worker_thread = QThread(self)
        self.worker.moveToThread(self.worker_thread)
        self.worker_thread.start()

        # queued request/complete wiring
        self.connect_requested.connect(self.worker.connect_to_hydrus)
        self.init_db_requested.connect(self.worker.init_db_connection)
        self.dedupe_requested.connect(self.worker.run_dedupe)
        self.skip_requested.connect(self.worker.skip_step, Qt.DirectConnection)
        self.maintenance_requested.connect(self.worker.run_maintenance_op)
        self.worker.connect_complete.connect(self.on_connect_complete)
        self.worker.init_db_complete.connect(self.on_init_db_complete)
        self.worker.dedupe_progress.connect(self.on_progress)
        self.worker.dedupe_complete.connect(self.on_dedupe_complete)
        self.worker.maintenance_complete.connect(self.on_maintenance_complete)

        self._build_ui()

    # -- UI ---------------------------------------------------------------

    def _build_ui(self) -> None:
        central = QWidget()
        layout = QVBoxLayout(central)

        conn_box = QGroupBox("Hydrus connection")
        form = QFormLayout(conn_box)
        self.api_url_edit = QLineEdit(config.HYDRUS_API_URL)
        self.api_key_edit = QLineEdit(config.HYDRUS_API_KEY or "")
        self.api_key_edit.setEchoMode(QLineEdit.Password)
        self.connect_button = QPushButton("Connect")
        self.connect_button.clicked.connect(self.connect_callback)
        form.addRow("API URL", self.api_url_edit)
        form.addRow("API key", self.api_key_edit)
        form.addRow(self.connect_button)
        layout.addWidget(conn_box)

        db_box = QGroupBox("Database")
        dbform = QFormLayout(db_box)
        self.db_dir_edit = QLineEdit(str(config.DEDUP_DATABASE_DIR))
        self.open_db_button = QPushButton("Open / create database")
        self.open_db_button.clicked.connect(self.open_db_callback)
        dbform.addRow("Directory", self.db_dir_edit)
        dbform.addRow(self.open_db_button)
        layout.addWidget(db_box)

        opt_box = QGroupBox("Options")
        optform = QFormLayout(opt_box)
        self.threshold_spin = QDoubleSpinBox()
        self.threshold_spin.setRange(0.0, 100.0)
        self.threshold_spin.setValue(50.0)
        self.skip_hashing_check = QCheckBox("Skip hashing (search only)")
        self.job_count_spin = QSpinBox()
        self.job_count_spin.setRange(-16, 64)
        self.job_count_spin.setValue(-2)
        self.job_count_spin.setToolTip(
            "CPU threads for hashing. -2 = all but one core, 0 = default."
        )
        self.query_edit = QLineEdit()
        self.query_edit.setPlaceholderText("optional custom query tags, ; separated")
        self.failed_page_edit = QLineEdit(config.FAILED_PAGE_NAME or "")
        self.search_backend_combo = QComboBox()
        self.search_backend_combo.addItems(["auto", "tree", "gpu"])
        self.search_prefilter_combo = QComboBox()
        self.search_prefilter_combo.addItems(["auto", "reps", "none"])
        self.search_prefilter_combo.setToolTip(
            "Exact scene-representative prune for the GPU engine: auto "
            "measures corpus compression, reps forces it, none disables."
        )
        self.search_backend_combo.setToolTip(
            "auto: GPU exact all-pairs engine when CUDA is available,\n"
            "else the VP-tree. tree: force the reference VP-tree search.\n"
            "gpu: force the device engine."
        )
        self.hash_backend_combo = QComboBox()
        self.hash_backend_combo.addItems(["auto", "native", "gpu"])
        self.hash_backend_combo.setToolTip(
            "native: threaded C++ hasher (reference behavior).\n"
            "gpu: device-batched hashing across all files."
        )
        self.decode_backend_combo = QComboBox()
        self.decode_backend_combo.addItems(["auto", "libav", "legacy"])
        self.decode_backend_combo.setToolTip(
            "auto: native FFmpeg decoder (reference-exact) with fallback.\n"
            "libav: native FFmpeg only. legacy: OpenCV/Pillow/y4m chain."
        )
        self.sampling_combo = QComboBox()
        self.sampling_combo.addItems(["uniform", "scene"])
        self.sampling_combo.setToolTip(
            "uniform: 1 frame/sec (reference parity).\n"
            "scene: keep only visually-distinct 1 fps candidates\n"
            "(changes hashes' frame sets; don't mix modes in one DB)."
        )
        optform.addRow("Similarity threshold", self.threshold_spin)
        optform.addRow(self.skip_hashing_check)
        optform.addRow("Job count", self.job_count_spin)
        optform.addRow("Search backend", self.search_backend_combo)
        optform.addRow("Search prefilter", self.search_prefilter_combo)
        optform.addRow("Hash backend", self.hash_backend_combo)
        optform.addRow("Frame sampling", self.sampling_combo)
        optform.addRow("Decode backend", self.decode_backend_combo)
        self.rerank_combo = QComboBox()
        self.rerank_combo.addItems(["none", "clip"])
        self.rerank_combo.setToolTip(
            "clip: gate candidate pairs on vision-embedding cosine\n"
            "similarity (needs a .npz checkpoint — see models/embed.py)."
        )
        self.rerank_weights_edit = QLineEdit()
        self.rerank_weights_edit.setPlaceholderText("path to vision checkpoint (.npz)")
        self.rerank_threshold_spin = QDoubleSpinBox()
        self.rerank_threshold_spin.setRange(-1.0, 1.0)
        self.rerank_threshold_spin.setSingleStep(0.05)
        self.rerank_threshold_spin.setValue(0.85)
        optform.addRow("Rerank", self.rerank_combo)
        optform.addRow("Rerank weights", self.rerank_weights_edit)
        optform.addRow("Rerank threshold", self.rerank_threshold_spin)
        optform.addRow("Custom query", self.query_edit)
        optform.addRow("Failed page name", self.failed_page_edit)
        layout.addWidget(opt_box)

        run_row = QHBoxLayout()
        self.run_button = QPushButton("Run deduplicator")
        self.run_button.clicked.connect(self.dedupe_callback)
        self.skip_button = QPushButton("Skip current step")
        self.skip_button.clicked.connect(self.skip_requested.emit)
        self.skip_button.setEnabled(False)
        run_row.addWidget(self.run_button)
        run_row.addWidget(self.skip_button)
        layout.addLayout(run_row)

        maint_box = QGroupBox("Maintenance")
        maint_row = QHBoxLayout(maint_box)
        for label, op in (
            ("Vacuum DB", "vacuum"),
            ("Clear search tree", "clear_search_tree"),
            ("Clear search cache", "clear_search_cache"),
            ("Reset potentials", "reset_potentials"),
        ):
            btn = QPushButton(label)
            btn.clicked.connect(lambda _=False, op=op: self.maintenance_requested.emit(op))
            maint_row.addWidget(btn)
        layout.addWidget(maint_box)

        self.progress_label = QLabel("")
        layout.addWidget(self.progress_label)
        self.log_view = QPlainTextEdit()
        self.log_view.setReadOnly(True)
        layout.addWidget(self.log_view)

        self.setCentralWidget(central)
        self.setStyleSheet(_DARK_STYLESHEET)

    # -- callbacks --------------------------------------------------------

    def _log(self, msg: str) -> None:
        if msg:
            self.log_view.appendPlainText(msg)

    def connect_callback(self) -> None:
        params = HydrusRequestParameters(
            api_url=self.api_url_edit.text().strip(),
            api_key=self.api_key_edit.text().strip(),
            verify_cert=config.REQUESTS_CA_BUNDLE,
            file_service_keys=config.HYDRUS_LOCAL_FILE_SERVICE_KEYS or [],
        )
        self.connect_button.setEnabled(False)
        self._log(f"Connecting to {params.api_url} ...")
        self.connect_requested.emit(params)

    def open_db_callback(self) -> None:
        self.open_db_button.setEnabled(False)
        self.init_db_requested.emit(Path(self.db_dir_edit.text().strip()))

    def dedupe_callback(self) -> None:
        params = DedupeParameters(
            threshold=self.threshold_spin.value(),
            skip_hashing=self.skip_hashing_check.isChecked(),
            job_count=self.job_count_spin.value(),
            custom_query=[q.strip() for q in self.query_edit.text().split(";") if q.strip()],
            failed_page_name=self.failed_page_edit.text().strip() or None,
            search_backend=self.search_backend_combo.currentText(),
            search_prefilter=self.search_prefilter_combo.currentText(),
            hash_backend=self.hash_backend_combo.currentText(),
            sampling=self.sampling_combo.currentText(),
            decode_backend=self.decode_backend_combo.currentText(),
            rerank=self.rerank_combo.currentText(),
            rerank_weights=self.rerank_weights_edit.text().strip(),
            rerank_threshold=self.rerank_threshold_spin.value(),
        )
        self.run_button.setEnabled(False)
        self.skip_button.setEnabled(True)
        self._log("Starting deduplication ...")
        self.dedupe_requested.emit(params)

    # -- worker completions -----------------------------------------------

    @Slot(bool, str)
    def on_connect_complete(self, ok: bool, msg: str) -> None:
        self.connect_button.setEnabled(True)
        self._log(msg)
        if not ok:
            QMessageBox.warning(self, "Connection failed", msg)

    @Slot(bool, str)
    def on_init_db_complete(self, ok: bool, msg: str) -> None:
        self.open_db_button.setEnabled(True)
        self._log(msg)
        if not ok:
            QMessageBox.warning(self, "Database error", msg)

    @Slot(str)
    def on_progress(self, text: str) -> None:
        self.progress_label.setText(text)

    @Slot(bool, str, int)
    def on_dedupe_complete(self, ok: bool, msg: str, pairs: int) -> None:
        self.run_button.setEnabled(True)
        self.skip_button.setEnabled(False)
        self._log(msg)
        if not ok:
            QMessageBox.warning(self, "Deduplication failed", msg)

    @Slot(bool, str)
    def on_maintenance_complete(self, ok: bool, msg: str) -> None:
        self._log(msg)
        if not ok:
            QMessageBox.warning(self, "Maintenance failed", msg)

    def closeEvent(self, event) -> None:
        self.worker_thread.quit()
        self.worker_thread.wait(5000)
        super().closeEvent(event)


def gui_main() -> None:
    import sys

    app = QApplication(sys.argv)
    window = MainWindow()
    window.show()
    sys.exit(app.exec())
