"""ArcGIS FeatureService REST queries to pandas DataFrames.

Counterpart of ``xrspatial_tpu/esri.py``, the same host code: no device
work.  ``requests`` is imported inside ``query_layer`` only.
"""

from __future__ import annotations

import pandas as pd

__all__ = ["featureset_to_dataframe", "query_to_dataframe", "query_layer"]


def featureset_to_dataframe(featureset, convert_geometry=False,
                            use_aliases=False):
    """Convert an ESRI featureset JSON dict to a DataFrame."""
    items = [x['attributes'] for x in featureset['features']]
    df = pd.DataFrame(items)
    if use_aliases and featureset.get('fieldAliases'):
        df.rename(columns=featureset['fieldAliases'], inplace=True)
    if convert_geometry:
        pass
    return df


def _chunker(seq, size):
    return (seq[pos:pos + size] for pos in range(0, len(seq), size))


def query_layer(layer, where, token=None, outFields='*', chunkSize=100,
                returnGeometry=False):
    """Query a FeatureService layer, paging through object ids."""
    import requests

    url = layer + r'/query'
    params = {
        'where': where,
        'outFields': outFields,
        'returnGeometry': returnGeometry,
        'token': token,
        'f': 'json',
        'returnIdsOnly': True,
    }
    ids_req = requests.post(url, data=params)
    ids_req.raise_for_status()
    ids_response = ids_req.json().get('objectIds') or []  # null = no rows
    params['returnIdsOnly'] = False
    params['where'] = ''

    featureset = None
    for ids in _chunker(ids_response, chunkSize):
        params['objectIds'] = ','.join(map(str, ids))
        req = requests.post(url, data=params)
        req.raise_for_status()
        feat_response = req.json()
        if not featureset:
            featureset = feat_response
        else:
            featureset['features'] += feat_response['features']
    if not featureset:
        featureset = {'features': []}
    return featureset


def query_to_dataframe(layer, where, token=None, outFields='*',
                       chunkSize=100, use_aliases=True):
    featureset = query_layer(layer, where, token, outFields, chunkSize)
    return featureset_to_dataframe(featureset, use_aliases=use_aliases)


def chunker(seq, size):
    """Yield successive `size`-sized slices of `seq`
    (reference esri.py:23-24)."""
    return (seq[pos:pos + size] for pos in range(0, len(seq), size))
