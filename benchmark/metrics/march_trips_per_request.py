"""DEM march (``pipelines/raycast``): trips of the march's host loop a
request over the window (the program's ``raycast.COUNTS["trips"]``); each
trip is ~150 kernels and one host read."""


def read(run):
    trips = run.counters.get("raycast.trips")
    return trips / run.requests if trips and run.requests else None
