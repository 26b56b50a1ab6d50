"""The host prologue per generate: the program's own stage times (its
StageTimer in production mode, read from PlanetResult.timing.stages) from
"Sphere mesh + upload" through "Upload plates, domes + noise tables":
numpy, scipy and native work that ends before any device stage."""

UNIT = "ms"
STAGES = ("Sphere mesh + upload", "Coarse plates", "Super plates",
          "Hotspot domes + noise tables",
          "Upload plates, domes + noise tables")


def read(trace):
    if not trace["calls"]:
        return None
    per_call = [sum(ms for name, ms in c["stages"] if name in STAGES)
                for c in trace["calls"]]
    return sum(per_call) / len(per_call)
