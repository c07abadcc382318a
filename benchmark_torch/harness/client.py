"""The load: a process of its own with one event loop, which serves the
stand-in for Ollama and drives the WebSocket clients (``serve.Client``).

    python3 -m benchmark_torch.harness.client

It prints ``{"ollama_port": P}``, then answers one JSON command per line
on standard input with one JSON line on standard output (the open loop
first prints ``{"window_start": t}``, the epoch second its first message
is due). Keeping the load out of the served process keeps its clock and
its sends off the server's interpreter lock.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

from benchmark_torch.harness import serve


def _msg(m: serve.Message, t0: float) -> dict:
    return {"text": m.text, "due": m.due - t0, "sources_at": None if m.sources_at is None else m.sources_at - t0,
            "sources": m.sources, "error": m.error}


async def main() -> None:
    from aiohttp import web

    ollama = web.AppRunner(serve.fake_ollama_app())
    await ollama.setup()
    await web.TCPSite(ollama, "127.0.0.1", 0).start()
    loop = asyncio.get_running_loop()
    reader = asyncio.StreamReader(limit=1 << 28)
    await loop.connect_read_pipe(lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)

    def say(obj) -> None:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    say({"ollama_port": ollama.addresses[0][1]})
    client = None
    try:
        while True:
            line = await reader.readline()
            if not line:
                break
            cmd = json.loads(line)
            op = cmd["cmd"]
            if op == "connect":
                client = serve.Client(cmd["base"], [cmd["module"]], cmd["per_session"])
                await client.__aenter__()
                t0 = time.perf_counter()
                while True:
                    try:
                        await client.status()
                        break
                    except OSError:
                        if time.perf_counter() - t0 > 120:
                            raise
                        await asyncio.sleep(0.2)
                say({"ok": True})
            elif op == "burst":
                t0 = time.perf_counter()
                msgs = await serve.burst(client, cmd["texts"])
                say({"messages": [_msg(m, t0) for m in msgs]})
            elif op == "fill":
                await client.fill(cmd["n"])
                say({"ok": True})
            elif op == "status":
                say(await client.status())
            elif op == "open_loop":
                t0 = time.perf_counter() + 0.2
                say({"window_start": time.time() + 0.2})
                msgs, late = await serve.open_loop(client, cmd["texts"], cmd["offsets"], t0, cmd["drain_s"])
                say({"messages": [_msg(m, t0) for m in msgs], "late": late})
            elif op == "closed_loop":
                texts = iter(cmd["texts"])
                t0 = time.perf_counter() + cmd["ramp_s"] + 0.2
                say({"window_start": time.time() + cmd["ramp_s"] + 0.2})
                msgs = await serve.closed_loop(client, cmd["sessions"], lambda: next(texts), t0 - cmd["ramp_s"],
                                               t0 + cmd["seconds"], cmd["drain_s"])
                say({"messages": [_msg(m, t0) for m in msgs]})
            elif op == "quit":
                break
    finally:
        if client is not None:
            await client.__aexit__(None, None, None)
        await ollama.cleanup()


if __name__ == "__main__":
    asyncio.run(main())
