from modern_search_engines_project_tpu_torch.crawler.fetch import (
    AsyncioTransport,
    Fetcher,
    FetchResult,
)
from modern_search_engines_project_tpu_torch.crawler.frontier import Frontier
from modern_search_engines_project_tpu_torch.crawler.helpers import (
    get_domain,
    normalize_url,
    parse_retry_after,
)
from modern_search_engines_project_tpu_torch.crawler.html_parser import parse_html
from modern_search_engines_project_tpu_torch.crawler.main import (
    Crawler,
    DEFAULT_SEEDS,
    run_crawler,
)
from modern_search_engines_project_tpu_torch.crawler.metric import (
    english_score,
    text_score,
    tue_eng_score,
    url_score,
)
from modern_search_engines_project_tpu_torch.crawler.robots import (
    RobotsCache,
    RobotsRules,
    parse_robots,
)
from modern_search_engines_project_tpu_torch.crawler.status_policy import (
    Decision,
    StatusPolicy,
)
from modern_search_engines_project_tpu_torch.crawler.storage import CrawlStore
from modern_search_engines_project_tpu_torch.crawler.utema import Utema

__all__ = [
    "AsyncioTransport",
    "Crawler",
    "CrawlStore",
    "DEFAULT_SEEDS",
    "Decision",
    "Fetcher",
    "FetchResult",
    "Frontier",
    "RobotsCache",
    "RobotsRules",
    "StatusPolicy",
    "Utema",
    "english_score",
    "get_domain",
    "normalize_url",
    "parse_html",
    "parse_retry_after",
    "parse_robots",
    "run_crawler",
    "text_score",
    "tue_eng_score",
    "url_score",
]
