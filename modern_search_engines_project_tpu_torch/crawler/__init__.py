from modern_search_engines_project_tpu_torch.crawler.storage import CrawlStore

__all__ = ["CrawlStore"]
