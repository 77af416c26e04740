"""The whole request: model FLOPs over the service time of the requests
outside the traced sub-window, as a share of the card's f32 peak, in %
(moves ``serve_segments_per_s``)."""
from benchmark.readings import serve_mfu as read  # noqa: F401
