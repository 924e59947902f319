from .http import StreamSessions, make_framewise_fn, make_http_server, serve_http
from .service import ServiceConfig, TaggingService
from .streaming import (
    Event,
    MultiStreamTagger,
    OnlineEventDetector,
    SoundEvent,
    StreamingConfig,
    StreamingTagger,
)

__all__ = [
    "TaggingService",
    "ServiceConfig",
    "StreamSessions",
    "make_framewise_fn",
    "make_http_server",
    "serve_http",
    "MultiStreamTagger",
    "StreamingTagger",
    "StreamingConfig",
    "Event",
    "OnlineEventDetector",
    "SoundEvent",
]
