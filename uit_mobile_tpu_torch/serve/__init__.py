from .service import ServiceConfig, TaggingService

__all__ = ["ServiceConfig", "TaggingService"]
