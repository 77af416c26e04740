"""Layer: the device. The share of the traced requests' service time
with no operation on the card, in % (moves ``serve_segments_per_s``)."""
from benchmark.readings import serve_idle_share as read  # noqa: F401
