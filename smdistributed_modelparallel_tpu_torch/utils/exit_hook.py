"""Exit-status capture for a consistent shutdown.

Counterpart of ``smdistributed_modelparallel_tpu/utils/exit_hook.py``
(reference ``backend/core.py:165-189``, ``ExitHook``): hooks ``sys.exit``
and ``sys.excepthook`` so ``smp.shutdown()`` knows whether the process is
dying cleanly. At world size 1 there is no peer to relay the status to;
``smp.shutdown()`` logs a failing one.
"""

import sys


class ExitHook:
    """Captures sys.exit codes and uncaught exceptions.

    Same surface as the reference class: ``hook()`` installs, ``exit_code``
    / ``exception`` record what ended the process, ``success`` derives the
    consistent status. ``unhook()`` restores the original handlers (the
    reference never unhooks; tests need to).
    """

    def __init__(self):
        self.exit_code = None
        self.exception = None
        self._orig_exit = None
        self._orig_excepthook = None

    def hook(self):
        if self._orig_exit is not None:
            return  # already installed
        self._orig_exit = sys.exit
        sys.exit = self.exit
        self._orig_excepthook = sys.excepthook
        sys.excepthook = self.exc_handler

    def unhook(self):
        if self._orig_exit is None:
            return
        sys.exit = self._orig_exit
        sys.excepthook = self._orig_excepthook
        self._orig_exit = None
        self._orig_excepthook = None

    def exit(self, code=0):
        self.exit_code = code
        self._orig_exit(code)

    def exc_handler(self, exc_type, exc, *args):
        self.exception = exc
        self._orig_excepthook(exc_type, exc, *args)

    @property
    def success(self):
        """True when nothing recorded a failing exit: no uncaught
        exception, and sys.exit (if called) carried a falsy code."""
        return not self.exit_code and self.exception is None
