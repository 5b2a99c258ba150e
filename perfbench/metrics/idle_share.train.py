"""Share of the traced window in which no kernel, copy or set ran on the
device (``readers.idle_share``)."""

from perfbench.harness.readers import idle_share as read  # noqa: F401
