"""The share of the traced window in which no operation ran on the card."""

from _common import idle_share as read  # noqa: F401
