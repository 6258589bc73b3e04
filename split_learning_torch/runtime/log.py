"""Structured logging with console mirroring.

Parity with the reference logger (``src/Log.py``): a file
logger writing timestamped records to ``{log_path}/app.log``, mirrored to
the console with ANSI colors, with ``[>>>]``/``[<<<]`` direction markers
for protocol messages and a ``debug_mode`` gate.  Additions: per-round
structured metrics records (JSON lines in ``metrics.jsonl``) so runs are
machine-readable, which the reference lacks (SURVEY.md §5.5).

Console mirroring runs THROUGH the logging stack (a color-formatting
``StreamHandler`` attached only when ``console=True``) rather than raw
``print_with_color`` calls next to it: every console line shares the
file record's timestamp (so console output lines up with app.log and
the span journals), and the ``console=False`` gate is structural — no
code path can print around it.

Every metrics record is stamped with a run-scoped :data:`RUN_ID`, the
writing ``participant`` and an explicit ``kind`` (default ``round``)
so interleaved runs separate cleanly, and each line is flushed as
written so a crashed run keeps its tail.

Run-scoped layout (``observability.run-scoped``, default on via
:func:`make_logger`): the output files — ``app.log``,
``metrics.jsonl``, and the span journals (``runtime/spans.py`` uses
:func:`run_output_dir` for the same directory) — are written under
``{log_path}/artifacts/runs/{RUN_ID}/`` with compat symlinks at the
old top-level paths, so every existing consumer keeps working while
successive runs stop appending into one shared metrics.jsonl.  A
pre-existing REGULAR file at a compat path is rotated to ``*.prev``
once (legacy data preserved) before the symlink is placed; on
filesystems without symlink support the layout silently degrades to
the flat one.
"""

from __future__ import annotations

import json
import logging
import pathlib
import sys
import threading
import time
import uuid

_COLORS = {
    "red": "\033[91m", "green": "\033[92m", "yellow": "\033[93m",
    "blue": "\033[94m", "magenta": "\033[95m", "cyan": "\033[96m",
    "white": "\033[97m", "reset": "\033[0m",
}

#: run-scoped id: one per process, stamped on every metrics record (and
#: adoptable via ``Logger(run_id=...)`` when a launcher coordinates
#: several processes of one logical run)
RUN_ID = uuid.uuid4().hex[:12]

_FMT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def run_output_dir(base: str | pathlib.Path,
                   run_id: str | None = None) -> pathlib.Path:
    """The run-scoped output directory under ``base``."""
    return pathlib.Path(base) / "artifacts" / "runs" / (run_id or RUN_ID)


def _proc_start(pid: int) -> str | None:
    """The pid's kernel start tick (/proc, Linux) — the identity that
    survives pid reuse; None where /proc is unavailable."""
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
        # field 22 (starttime); comm (field 2) may contain spaces, so
        # split after the closing paren
        return stat.rsplit(")", 1)[1].split()[19]
    except (OSError, IndexError):
        return None


def write_run_owner(run_dir: pathlib.Path,
                    run_id: str | None = None) -> None:
    """Stamp ``run_dir/.owner`` with this process's pid + start tick:
    how :func:`compat_link` tells a LIVE concurrent process's link
    (follow it — multi-process deployments keep one merged metrics
    stream) from a DEAD previous run's (re-point it — a new run must
    not append into last week's directory)."""
    import os
    try:
        (run_dir / ".owner").write_text(
            f"{os.getpid()} {_proc_start(os.getpid()) or '-'} "
            f"{run_id or RUN_ID}\n")
    except OSError:
        pass


def _owner_alive(run_dir: pathlib.Path) -> bool:
    import os
    try:
        parts = (run_dir / ".owner").read_text().split()
        pid = int(parts[0])
    except (OSError, ValueError, IndexError):
        return False       # pre-owner-stamp runs are by definition dead
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        pass               # exists but not ours — keep checking
    # pid alive — but is it the SAME process?  After a reboot (or pid
    # wraparound) a recycled pid must not pin a dead run's symlink.
    stamped = parts[1] if len(parts) >= 3 else None
    if stamped and stamped != "-":
        return _proc_start(pid) == stamped
    return True


def compat_link(link: pathlib.Path, target: pathlib.Path) -> bool:
    """Best-effort compat symlink ``link -> target`` (relative).

    A pre-existing regular file is rotated aside to ``<name>.prev``
    (legacy cross-run data is preserved, not clobbered).  A symlink
    pointing at another run dir whose owner process is still ALIVE
    (``.owner`` pid, :func:`write_run_owner`) is a concurrent process
    of the same deployment and is left alone — returns False, and the
    caller falls back to the flat path, whose writes then resolve
    *through* the winner's link, keeping today's one-merged-file
    behavior (bench and the trace validator read the union).  A link
    whose owner is dead is a PREVIOUS run's leftover and is
    re-pointed, so new runs never append into old directories.  Also
    False when the filesystem refuses symlinks entirely."""
    import os
    try:
        rel = os.path.relpath(target, link.parent)
        if link.is_symlink():
            if os.readlink(link) == rel:
                return True
            old_target = (link.parent / os.readlink(link)).parent
            if _owner_alive(old_target):
                return False   # live concurrent process: follow it
            link.unlink()      # dead run's leftover: take over
        elif link.exists():
            prev = link.with_name(link.name + ".prev")
            if prev.exists():
                return False   # already rotated once; leave it alone
            link.rename(prev)
        try:
            link.symlink_to(rel)
        except FileExistsError:   # lost a creation race
            return link.is_symlink() and os.readlink(link) == rel
        return True
    except OSError:
        return False


def _scoped_root(root: pathlib.Path, run_id: str,
                 names: tuple = ("app.log", "metrics.jsonl")
                 ) -> pathlib.Path:
    """Resolve the run-scoped output dir + compat symlinks; falls back
    to ``root`` itself when symlinks are unavailable."""
    out = run_output_dir(root, run_id)
    try:
        out.mkdir(parents=True, exist_ok=True)
    except OSError:
        return root
    write_run_owner(out, run_id)
    for name in names:
        if not compat_link(root / name, out / name):
            return root
    return out

#: colors applied by level when the call site names none
_LEVEL_COLORS = {logging.WARNING: "yellow", logging.ERROR: "red",
                 logging.DEBUG: "cyan"}


def print_with_color(text: str, color: str = "white") -> None:
    """Raw colored stdout write (reference ``Log.py`` parity helper).
    Logger no longer routes console output here — its mirror runs
    through the :class:`_ColorFormatter` handler so every console line
    is timestamped and structurally gated by ``console=False``."""
    sys.stdout.write(f"{_COLORS.get(color, '')}{text}{_COLORS['reset']}\n")


class _ColorFormatter(logging.Formatter):
    """app.log format + ANSI color from ``extra={'color': ...}`` (or
    the level default), for the console mirror handler."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        color = getattr(record, "color", None) \
            or _LEVEL_COLORS.get(record.levelno)
        if color in _COLORS:
            return f"{_COLORS[color]}{base}{_COLORS['reset']}"
        return base


class Logger:
    """File + console logger with structured metrics sidecar."""

    def __init__(self, log_path: str | pathlib.Path = ".",
                 debug: bool = False, console: bool = True,
                 name: str = "split_learning_torch",
                 run_id: str | None = None, run_scoped: bool = False,
                 metrics_max_mb: float = 0.0, metrics_keep: int = 4):
        self.debug_mode = debug
        self.console = console
        self.participant = name
        self.run_id = run_id or RUN_ID
        # metrics.jsonl size-based rotation
        # (observability.metrics-max-mb): 0 disables; otherwise the
        # active file rotates to metrics.jsonl.1..keep once it crosses
        # the cap.  The ACTIVE path never changes, so the run-scoped
        # compat symlink stays valid across rotations (the rename +
        # reopen is atomic at the path level: os.replace).
        self._metrics_max = int(float(metrics_max_mb) * (1 << 20))
        self._metrics_keep = max(1, int(metrics_keep))
        root = pathlib.Path(log_path)
        root.mkdir(parents=True, exist_ok=True)
        # run-scoped layout: files land under artifacts/runs/<run_id>/
        # with compat symlinks at the flat paths (see module docstring)
        out = _scoped_root(root, self.run_id) if run_scoped else root
        self.output_dir = out
        self._metrics_path = out / "metrics.jsonl"
        self._metrics_lock = threading.Lock()
        self._metrics_f = None
        self._log = logging.getLogger(f"{name}.{id(self):x}")
        self._log.setLevel(logging.DEBUG)
        self._log.propagate = False
        # id() values recycle: a reused registry entry may still carry a
        # previous Logger's handler — drop any stale ones
        for h in list(self._log.handlers):
            self._log.removeHandler(h)
            h.close()
        handler = logging.FileHandler(out / "app.log")
        # %(name)s carries the participant ("server"/"{client_id}"):
        # an in-process cell interleaves every participant in ONE
        # app.log, and the protocol-model trace validator
        # (analysis/model.py events_from_log) needs it to replay each
        # participant's state machine separately
        handler.setFormatter(logging.Formatter(_FMT))
        self._log.addHandler(handler)
        self._handler = handler
        self._console_handler = None
        if console:
            ch = logging.StreamHandler(sys.stdout)
            ch.setFormatter(_ColorFormatter(_FMT))
            self._log.addHandler(ch)
            self._console_handler = ch

    def _emit(self, level: int, msg: str, color: str | None = None):
        self._log.log(level, msg,
                      extra=None if color is None else {"color": color})

    def info(self, msg: str, color: str = "white") -> None:
        self._emit(logging.INFO, msg, color)

    def warning(self, msg: str) -> None:
        self._emit(logging.WARNING, msg)

    def error(self, msg: str) -> None:
        self._emit(logging.ERROR, msg)

    def debug(self, msg: str) -> None:
        if self.debug_mode:
            self._emit(logging.DEBUG, msg)

    def sent(self, msg: str) -> None:
        """Outbound protocol message (reference's red ``[>>>]`` marker)."""
        self.info(f"[>>>] {msg}", "red")

    def received(self, msg: str) -> None:
        """Inbound protocol message (reference's blue ``[<<<]`` marker)."""
        self.info(f"[<<<] {msg}", "blue")

    def metric(self, **fields) -> None:
        """Append one structured metrics record (JSON line), stamped
        ``run_id``/``participant``/``kind`` and flushed immediately so
        a crashed run keeps every completed record."""
        rec = {"ts": time.time(), "run_id": self.run_id,
               "participant": self.participant,
               "kind": fields.pop("kind", "round")}
        rec.update(fields)
        line = json.dumps(rec) + "\n"
        with self._metrics_lock:
            if self._metrics_f is None or self._metrics_f.closed:
                self._metrics_f = open(self._metrics_path, "a")
            self._metrics_f.write(line)
            self._metrics_f.flush()
            if self._metrics_max and \
                    self._metrics_f.tell() >= self._metrics_max:
                self._rotate_metrics_locked()

    def _rotate_metrics_locked(self) -> None:
        """Shift metrics.jsonl -> .1 -> ... -> .keep (oldest dropped)
        and reopen the active path.  Readers (``sl_top --journal``,
        ``sl_perf``, the bench scavengers) glob ``metrics.jsonl*`` and
        read oldest-first, so a rotated run reads exactly like an
        unrotated one.  Best-effort: a failed rename must never kill
        the writer mid-round."""
        import os
        try:
            self._metrics_f.close()
            p = self._metrics_path
            oldest = p.with_name(f"{p.name}.{self._metrics_keep}")
            if oldest.exists():
                oldest.unlink()
            for i in range(self._metrics_keep - 1, 0, -1):
                src = p.with_name(f"{p.name}.{i}")
                if src.exists():
                    os.replace(src, p.with_name(f"{p.name}.{i + 1}"))
            os.replace(p, p.with_name(f"{p.name}.1"))
        except OSError:
            pass
        self._metrics_f = open(self._metrics_path, "a")

    @classmethod
    def for_run(cls, cfg, name: str, console: bool = False,
                run_id: str | None = None) -> "Logger":
        """Config-driven construction: honors
        ``observability.run-scoped`` (the entry points' path; direct
        ``Logger(...)`` keeps the flat layout for tools and tests)."""
        obs = getattr(cfg, "observability", None)
        return cls(cfg.log_path, debug=cfg.debug, console=console,
                   name=name, run_id=run_id,
                   run_scoped=bool(obs is not None and obs.run_scoped),
                   metrics_max_mb=getattr(obs, "metrics_max_mb", 0.0)
                   if obs is not None else 0.0,
                   metrics_keep=getattr(obs, "metrics_keep", 4)
                   if obs is not None else 4)

    def close(self) -> None:
        self._handler.close()
        self._log.removeHandler(self._handler)
        if self._console_handler is not None:
            self._log.removeHandler(self._console_handler)
            self._console_handler = None
        with self._metrics_lock:
            if self._metrics_f is not None and not self._metrics_f.closed:
                self._metrics_f.close()
