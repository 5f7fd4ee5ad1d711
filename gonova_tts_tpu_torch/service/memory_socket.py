"""An in-memory WebSocket for `TTSService.handle_connection`, with the client's side.

The service sees what it sees of an aiohttp socket: an async iterator of inbound
messages (`.type`, `.data`) and `send_json` / `send_bytes` / `close`. The client puts
messages in (`send`) and reads every outbound frame in order (`receive`, or
`request` for the frames up to an answer); each frame is recorded with
`time.perf_counter()`. The client ends the stream (`end`: a CLOSE message) only
after its last answer: the service drops a connection's pending output as soon as
its receive side ends. Serves where aiohttp is not installed.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import List, Sequence, Tuple

from .server import WSMsgType


class MemorySocket:
    class Msg:
        def __init__(self, type_, data):
            self.type, self.data = type_, data

    def __init__(self):
        self.inbound: asyncio.Queue = asyncio.Queue()
        self.frames: List[Tuple[float, str, object]] = []  # (perf_counter, "json" | "binary", payload)
        self.changed = asyncio.Event()
        self.closed = False
        self._read = 0

    # ---------------------------------------------------------------- the service's side

    def __aiter__(self):
        return self

    async def __anext__(self):
        msg = await self.inbound.get()
        if msg is None:
            raise StopAsyncIteration
        return msg

    def _record(self, kind, payload):
        self.frames.append((time.perf_counter(), kind, payload))
        self.changed.set()

    async def send_json(self, data):
        self._record("json", data)

    async def send_bytes(self, data):
        self._record("binary", bytes(data))

    async def close(self, **_):
        self.closed = True

    # ---------------------------------------------------------------- the client's side

    async def send(self, message: dict) -> float:
        """Queue one JSON message for the service; returns the send time."""
        t0 = time.perf_counter()
        await self.inbound.put(self.Msg(WSMsgType.TEXT, json.dumps(message)))
        return t0

    async def _wait(self, timeout: float) -> None:
        self.changed.clear()
        await asyncio.wait_for(self.changed.wait(), timeout)

    async def receive(self, timeout: float = 600) -> Tuple[str, object]:
        """The next outbound frame not read yet: ("json", dict) or ("binary", bytes)."""
        while self._read >= len(self.frames):
            await self._wait(timeout)
        _, kind, payload = self.frames[self._read]
        self._read += 1
        return kind, payload

    async def request(self, message: dict, until: Sequence[str], timeout: float = 120):
        """Send one message; return (send time, the frames from then up to and
        including the first JSON frame whose type is in `until`)."""
        start = len(self.frames)
        t0 = await self.send(message)
        while True:
            for i in range(start, len(self.frames)):
                _, kind, payload = self.frames[i]
                if kind == "json" and payload.get("type") in until:
                    self._read = max(self._read, i + 1)
                    return t0, self.frames[start:i + 1]
            await self._wait(timeout)

    async def end(self) -> None:
        await self.inbound.put(self.Msg(WSMsgType.CLOSE, None))
        await self.inbound.put(None)
