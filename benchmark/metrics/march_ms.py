"""DEM march (``GeoInverter.march``: the march's set-up and its trips, each
ending in one host read): the mean a request of the program's
``geo.march`` spans under ``pixel_to_geo``, ms."""

import program_spans


def read(run):
    return program_spans.span_ms(run, "geo.march", under="pixel_to_geo")
