"""Unified chat routing facade (reference services/chat_service.py:28-172).

Single entry point over RAGService for callers that don't speak the
streaming generator protocol: ``execute`` collects the stream into one
response; ``query`` re-exposes the generator; ``extract_sources`` converts
engine sources into API dicts.
"""

from __future__ import annotations

from tensortruth_tpu_torch.services.rag_service import RAGChunk, RAGResponse, RAGService


class ChatService:
    def __init__(self, rag_service: RAGService):
        self.rag_service = rag_service

    def query(self, prompt: str, params: dict | None = None,
              session_messages: list[dict] | None = None):
        """Streaming generator passthrough (yields RAGChunk, returns RAGResponse)."""
        return self.rag_service.query(prompt, params, session_messages)

    def execute(self, prompt: str, params: dict | None = None,
                session_messages: list[dict] | None = None) -> RAGResponse:
        """Non-streaming: pump the generator to completion."""
        gen = self.query(prompt, params, session_messages)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value

    @staticmethod
    def extract_sources(response: RAGResponse) -> list[dict]:
        return [s.to_dict() for s in response.sources]
