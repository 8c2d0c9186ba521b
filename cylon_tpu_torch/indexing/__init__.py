from .indexer import ILocIndexer, LocIndexer

__all__ = ["ILocIndexer", "LocIndexer"]
