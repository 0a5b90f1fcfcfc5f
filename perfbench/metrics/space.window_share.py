"""space.window_share (%): the space probes whose placement came from the
window engine's centred sub-mesh, over the space probes that found one, in
the compile service's workers over the traced window.

Each ``space.probe`` span of the workers' ``obs`` shards carries ``region``:
``window`` where the exact engine placed the partition on the centred
sub-mesh of a large homogeneous mesh, ``fabric`` where an engine placed it on
the whole fabric, empty where none did (``core/mapper.py``,
``core/space_backends/window.py``). A falling share means the whole-fabric
fallback does the work. None where no found probe carries a region."""


def read(record):
    regions = [e["args"]["region"] for e in record.get("obs_events") or []
               if e.get("name") == "space.probe" and e.get("ph") == "X"
               and e.get("args", {}).get("outcome") == "found"
               and e["args"].get("region")]
    if not regions:
        return None
    return 100.0 * regions.count("window") / len(regions)
