"""Minimal scikit-learn estimator protocol, without importing scikit-learn.

``get_params``/``set_params`` follow sklearn's conventions (parameters are
the ``__init__`` keyword arguments, stored as same-named attributes), which
is all ``sklearn.base.clone`` and ``sklearn.pipeline.Pipeline`` need from a
transformer. scikit-learn stays an optional dependency.
"""
from __future__ import annotations

import inspect


class EstimatorBase:
    """Parameter access for estimators whose ``__init__`` only stores its
    keyword arguments."""

    @classmethod
    def _param_names(cls):
        sig = inspect.signature(cls.__init__)
        return sorted(p.name for p in sig.parameters.values()
                      if p.name != "self" and p.kind == p.POSITIONAL_OR_KEYWORD)

    def get_params(self, deep: bool = True) -> dict:
        """Constructor parameters by name (``deep`` also expands nested
        estimators' parameters as ``name__param``, as sklearn does)."""
        out = {}
        for name in self._param_names():
            value = getattr(self, name)
            if deep and hasattr(value, "get_params") \
                    and not isinstance(value, type):
                out.update((f"{name}__{k}", v)
                           for k, v in value.get_params().items())
            out[name] = value
        return out

    def set_params(self, **params):
        """Set constructor parameters; unknown names raise ValueError."""
        valid = set(self._param_names())
        for key, value in params.items():
            name, _, sub = key.partition("__")
            if name not in valid:
                raise ValueError(
                    f"invalid parameter {name!r} for {type(self).__name__}; "
                    f"valid parameters are {sorted(valid)}")
            if sub:
                getattr(self, name).set_params(**{sub: value})
            else:
                setattr(self, name, value)
        return self

    def __sklearn_tags__(self):
        """Estimator tags for scikit-learn ≥ 1.6, which asks every
        pipeline step for them (only scikit-learn calls this)."""
        from sklearn.utils import InputTags, Tags, TargetTags, TransformerTags

        return Tags(estimator_type="transformer",
                    target_tags=TargetTags(required=False),
                    transformer_tags=TransformerTags(),
                    input_tags=InputTags(sparse=True))

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}" for k, v in
                         self.get_params(deep=False).items())
        return f"{type(self).__name__}({args})"
