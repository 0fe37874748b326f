from .textcheck import check_exposition
from .registry import Counter, Gauge, Histogram, Registry, Metrics
from .store import MetricsStore
