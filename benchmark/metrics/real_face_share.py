"""real_face_share.patch, real_face_share.whole: real facets over padded
facet rows of the samples the window's steps took, in percent (a count; it
repeats exactly)."""


def read(ctx):
    if ctx["mode"] != "train":
        return None
    c = ctx["counters"]
    return 100.0 * c["faces"] / c["padded_faces"]
