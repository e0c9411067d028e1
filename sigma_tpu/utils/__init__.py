"""Utility subpackage: profiling (device-synchronized timers), checks
(checkify/debug validation), dtypes, and host/util helpers.  A regular
package (not a PEP-420 namespace one) so packaging tools ship it with
the rest of the library."""
