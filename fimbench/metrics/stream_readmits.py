"""Segments the stream prepared again a request, from the program's
counter ``stream.readmitted_segments`` (added at every query of a floored
stream, 0 included); none where the program keeps no such counter."""
from fimbench import spans


def read(run):
    row = spans.table().get("stream.readmitted_segments")
    if row is None or not run.requests:
        return None
    return row["total"] / len(run.requests)
