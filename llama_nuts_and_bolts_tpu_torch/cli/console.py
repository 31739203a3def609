"""Live-repainting console state for streaming generation.

Capability parity with the reference's AppState repaint engine (reference:
cmd/main.go:354-564): a block of status lines (progress counter, latest token,
elapsed clocks, prompt, assistant text, waiting-tokens line) is reprinted on
every update by erasing the previously painted lines with ANSI ``\\x1b[2K`` +
cursor-up, with line-width bookkeeping that accounts for terminal-width
wrapping. The ``…`` placeholder marks byte-fallback tokens still waiting to
complete a codepoint, and the emoji spacing hack keeps wide glyphs from
overlapping the annotation that follows them.
"""

from __future__ import annotations

import math
import re
import shutil
import sys
import time
from typing import IO, List, Optional

from llama_nuts_and_bolts_tpu_torch.runtime.types import (
    GeneratedPart,
    GenerationState,
    TokenPiece,
)

WAITING_CHAR = "…"
_ANSI_RE = re.compile("\x1b\\[\\d+[a-zA-Z]")


def spaces_after_emoji(waiting_runes_extra_str: str) -> str:
    """Spacer between a wide emoji glyph and its annotation (reference:
    cmd/main.go:319-335): one space per '[' in the annotation, capped at 2."""
    if not waiting_runes_extra_str:
        return ""
    count = min(waiting_runes_extra_str.count("["), 2)
    return " " * count


class AppState:
    def __init__(self, out: Optional[IO[str]] = None,
                 fixed_width: Optional[int] = None) -> None:
        self.out: IO[str] = out if out is not None else sys.stdout
        self.fixed_width = fixed_width  # tests pin 80 like the reference

        self.prompt_text = ""
        self.prompt_tokens: List[TokenPiece] = []
        self.generated_text = ""
        self.generated_token_ids: List[int] = []
        self.generated_tokens: List[TokenPiece] = []
        self.added_to_waiting_count = 0
        self.waiting_runes_extra_str = ""
        self.generation_state = GenerationState.IN_PROGRESS
        self.latest_log_text = ""
        self.literal_progress_text = ""
        self.sequence_length = 0
        self.start_time_total: Optional[float] = None
        self.start_time_token: Optional[float] = None

        self._prev_line_widths: List[int] = []
        self._spaces_after_emoji = ""

    # ----------------------------------------------------------- painting

    def _width(self) -> int:
        if self.fixed_width is not None:
            return self.fixed_width
        return shutil.get_terminal_size(fallback=(80, 24)).columns

    def _erase_previous(self) -> str:
        if not self._prev_line_widths:
            return ""
        width = self._width()
        lines = 0
        for w in self._prev_line_widths:
            lines += max(1, math.ceil(w / width)) if w > 0 else 1
        parts = []
        for i in range(lines):
            parts.append("\x1b[2K\r")
            if i < lines - 1:
                parts.append("\x1b[1A")
        return "".join(parts)

    def _print_line(self, buf: List[str], widths: List[int], text: str = "") -> None:
        for line in text.split("\n"):
            widths.append(len(_ANSI_RE.sub("", line)))
        buf.append(text + "\n")
        widths.append(0)

    def update_output(self) -> None:
        erase = self._erase_previous()
        buf: List[str] = []
        widths: List[int] = []
        if not self.latest_log_text:
            self.latest_log_text = WAITING_CHAR

        total_str, token_str = self._durations_to_str()
        self._print_line(buf, widths, "Press Ctrl+C to exit.")
        self._print_line(buf, widths, self._progress_text())
        self._print_line(
            buf, widths,
            f"{'Total elapsed':<23}: \x1b[1m{total_str}\x1b[0m, "
            f"elapsed for next token: \x1b[1m{token_str}\x1b[0m")
        self._print_line(buf, widths, f"{'Running for next token':<23}: {self.latest_log_text}")
        self._print_line(buf, widths, "")
        if self.prompt_text:
            generated = self.generated_text + self.waiting_runes_extra_str
            generated += WAITING_CHAR * self.added_to_waiting_count
            if not generated:
                generated = WAITING_CHAR
            self._print_line(buf, widths, f"\x1b[1m{'Prompt':<23}:\x1b[0m \"{self.prompt_text}\"")
            self._print_line(buf, widths, f"\x1b[1m{'Assistant':<23}:\x1b[0m \"{generated}\"")
            if self.added_to_waiting_count > 0:
                waiting = self.generated_tokens[-self.added_to_waiting_count:]
                items = ", ".join(f'"{t.byte_fallback_string()}"' for t in waiting)
                self._print_line(
                    buf, widths,
                    f"\x1b[1m{'Tokens waiting to be processed further':<23}:\x1b[0m "
                    f"{items}, possibly a part of an upcoming emoji)")
        else:
            self._print_line(buf, widths, WAITING_CHAR)

        self._prev_line_widths = widths
        self.out.write(erase + "".join(buf))
        self.out.flush()

    # ------------------------------------------------------------- updates

    def begin_generation(self, prompt_tokens: List[TokenPiece], prompt_text: str,
                         sequence_length: int) -> None:
        self.prompt_tokens = prompt_tokens
        self.prompt_text = prompt_text
        self.sequence_length = sequence_length
        self.start_time_total = time.monotonic()
        self.start_time_token = self.start_time_total
        self._prev_line_widths = []
        self.generated_text = ""
        self.generated_token_ids = []
        self.generated_tokens = []
        self.update_output()

    def consume(self, part: GeneratedPart) -> None:
        """Apply one GeneratedPart (reference: cmd/main.go:153-209)."""
        if not part.is_resend_of_waiting:
            self.generated_token_ids.append(part.token_id)
            self.generated_tokens.append(part.token)

        decoded = part.decoded_string
        extra = part.waiting_runes_extra_str
        if self._spaces_after_emoji and not extra:
            decoded = self._spaces_after_emoji + decoded
            self._spaces_after_emoji = ""
        else:
            self._spaces_after_emoji = spaces_after_emoji(extra)
            extra = self._spaces_after_emoji + extra
        self.waiting_runes_extra_str = extra

        if part.added_to_waiting:
            self.added_to_waiting_count += 1
        else:
            self.added_to_waiting_count = 0
            self.generated_text += decoded
        self.generation_state = part.generation_state
        self.update_output()
        self.start_time_token = time.monotonic()

    def finish_generation(self) -> None:
        # fold a pending emoji annotation into the text with one final
        # repaint (reference: cmd/main.go:204-209 post-loop flush)
        if self.waiting_runes_extra_str:
            # the stored extra already carries its leading spaces (consume())
            self.generated_text += self.waiting_runes_extra_str
            self.waiting_runes_extra_str = ""
            self.update_output()
        self.waiting_runes_extra_str = ""
        self.out.write("\n")
        self.out.flush()

    # ------------------------------------------------------------ fragments

    def _progress_text(self) -> str:
        if self.literal_progress_text:
            return self.literal_progress_text
        latest = "(generating)" if not self.generated_tokens else str(self.generated_tokens[-1])
        next_num = len(self.prompt_tokens) + len(self.generated_tokens)
        if next_num < self.sequence_length:
            next_num += 1
        return (
            f"\x1b[1m{'Generating tokens':<23}: {next_num} / {self.sequence_length}, "
            f"including {len(self.prompt_tokens)} prompt tokens...\x1b[0m\n"
            f"{'Latest generated token':<23}: {latest}"
        )

    def _durations_to_str(self):
        if self.start_time_total is None:
            return "..:..", "..:.."
        total = int(time.monotonic() - self.start_time_total)
        h, rem = divmod(total, 3600)
        m, s = divmod(rem, 60)
        token = time.monotonic() - (self.start_time_token or 0)
        return f"{h:02d}h:{m:02d}m:{s:02d}s", f"{token:.4f} sec(s)"
