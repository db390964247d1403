"""Trainer and graphed programs: host calls that put work on a stream
(kernel launches, graph launches, asynchronous copies and fills) per train
step, from the profiler's host events."""


def read(record):
    launches = record.get("summary", {}).get("launches")
    if not launches or not record.get("units"):
        return None
    return sum(launches.values()) / record["units"]
