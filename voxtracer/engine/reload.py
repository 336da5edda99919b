"""Kernel hot-reload: the shader-watcher reborn for Python kernels.

The reference watches ``shaders/`` and recompiles GLSL through
``glslangValidator`` on change, keeping the old pipeline on failure
(``src/context.rs:1637-1657``, ``src/context/shader.rs``).  Here the
"shaders" are the Python kernel modules (``voxtracer.ops.*``): an mtime
poll detects edits, reimports the module, and rebuilds the jitted frame
function; a failed import/compile logs the error and keeps rendering
with the previous code — live kernel tweaking stays non-fatal.
"""

from __future__ import annotations

import importlib
import logging
import os
import sys
import time
from typing import Callable, Dict, Iterable, Optional

log = logging.getLogger("voxtracer.engine.reload")

WATCHED_MODULES = (
    "voxtracer.ops.trace_triton",
    "voxtracer.ops.trace_xla",
    "voxtracer.ops.temporal",
    "voxtracer.ops.denoise",
    "voxtracer.ops.tonemap",
    "voxtracer.ops.noise",
)


class KernelWatcher:
    """Polls kernel-module source mtimes; on change reloads the modules
    and invokes ``on_reload`` (typically: drop jit caches, rebuild the
    pipeline).  Debounced like the reference's 500 ms notify watcher."""

    def __init__(
        self,
        on_reload: Optional[Callable[[], None]] = None,
        modules: Iterable[str] = WATCHED_MODULES,
        debounce: float = 0.5,
    ):
        self.on_reload = on_reload
        self.modules = list(modules)
        self.debounce = debounce
        self._mtimes: Dict[str, float] = {}
        self._last_event = 0.0
        self._snapshot()

    def _files(self):
        for name in self.modules:
            mod = sys.modules.get(name)
            if mod is None or not getattr(mod, "__file__", None):
                continue
            yield name, mod.__file__

    def _snapshot(self):
        for name, path in self._files():
            try:
                self._mtimes[name] = os.stat(path).st_mtime
            except OSError:
                pass

    def poll(self) -> bool:
        """Check for changes; reload if any. Returns True on reload."""
        changed = []
        for name, path in self._files():
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            if mtime != self._mtimes.get(name):
                changed.append(name)
                self._mtimes[name] = mtime

        if not changed:
            return False
        now = time.monotonic()
        if now - self._last_event < self.debounce:
            return False
        self._last_event = now

        for name in changed:
            try:
                importlib.reload(sys.modules[name])
                log.info("reloaded kernel module %s", name)
            except Exception:
                # non-fatal, like the reference's shader-compile errors
                log.exception(
                    "reload of %s failed; keeping previous kernels", name
                )
                return False
        if self.on_reload is not None:
            try:
                self.on_reload()
            except Exception:
                log.exception("pipeline rebuild failed after reload")
                return False
        return True
