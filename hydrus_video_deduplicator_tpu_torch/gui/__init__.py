"""Optional PySide6 GUI (install extra: ``[gui]``).

Importing :mod:`.gui` requires PySide6; the CLI entrypoint catches the
ImportError and reports how to install the GUI dependencies
(entrypoint.run_main), matching the reference's behavior.
"""
