"""Input state (a copy of ``bibim_tpu.scene.input``, the reference's
src/input.h/.cpp).

The reference maps SDL keycodes to booleans plus mouse button/pos/delta.
Here keys are strings ('w', 'a', 's', 'd', ...) fed by whatever host event
source drives the app (scripted replay, the live viewer, or tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Input:
    mouse_down: bool = False
    cursor_pos: tuple[int, int] = (0, 0)
    cursor_delta: tuple[int, int] = (0, 0)
    _keys: dict[str, bool] = field(default_factory=dict)

    def process_key_event(self, key: str, pressed: bool) -> None:
        self._keys[key.lower()] = pressed

    def is_key_down(self, key: str) -> bool:
        return self._keys.get(key.lower(), False)

    def update_cursor(self, x: int, y: int) -> None:
        px, py = self.cursor_pos
        self.cursor_delta = (x - px, y - py)
        self.cursor_pos = (x, y)

    def movement_direction(self) -> tuple[int, int]:
        """(strafe, forward) from WASD (main.cpp:1243-1257)."""
        strafe = int(self.is_key_down("d")) - int(self.is_key_down("a"))
        forward = int(self.is_key_down("w")) - int(self.is_key_down("s"))
        return strafe, forward
